// Greedy furthest point sampling (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/fps.py:fps_pallas (_fps_kernel),
// whose contract is fps_jax: start at index 0; each step pick the point
// with the largest running min squared distance to the picked set, first
// index on ties; points with |p|^2 <= 1e-3 are never picked and never
// update their running distance.
//
// Squared norms and distances are written with explicit round-to-nearest
// intrinsics, fma(dz, dz, fma(dy, dy, dx * dx)): the rounding of the plain
// version and of fps_jax as XLA evaluates it. Exact distance ties are
// common on voxel lattice points, so any other order picks other indices.
//
// What bounds it on the H100: npoint - 1 dependent steps, each a pass over
// all N points and an argmax over them. The arithmetic is small (0.02 ms
// at N = 32768, npoint 4096); the time is the latency of a chain of
// stages per step, and above all of the one exchange across the SMs that
// share a batch row. Design: a thread-block cluster of CL CTAs per batch
// row (8, or 16 as a non-portable cluster) of NT threads.
// - Point g = k * CL * NT + rank * NT + tid lives in thread tid of CTA
//   `rank`, slot k: each thread keeps x, y, z and the running distance of
//   its PPT points in registers (PPT a template tier, chosen by the
//   wrapper from N). A point that is never picked (|p|^2 <= 1e-3, or past
//   N) starts at distance -1, and fminf(-1, d) keeps it there: the skip
//   test runs once, at load. Each CTA also keeps a float4 copy of its
//   points in shared memory: each thread loads its candidate's
//   coordinates from it while the warp reduces, and the warp winner's
//   lane shuffles them to the lanes that publish.
// - A candidate is one packed u32 key: 0 for a distance of -1, else the
//   float's bits + 1 (d >= 0 orders as its bits; -1 loses to 0, which
//   decides rows with fewer valid points than npoint). A thread's best is
//   a tree over its slots (the lower slot on ties: indices ascend with
//   k); a warp's is redux.sync max over the keys, then redux.sync min over
//   the indices of the lanes that hold the max.
// - One exchange per step, no __syncthreads: lanes 0..CL-1 of every warp
//   write the warp's (key, index) and the winner's coordinates into the
//   warp's own slot in every CTA of the cluster (distributed shared
//   memory); after one cluster-wide synchronisation each warp reduces all
//   CL * NT / 32 slots from its own shared memory (the same two redux) and
//   reads the winner's coordinates from the slot that its index names.
//   Two transports (template flag PUSH): a cluster barrier
//   (barrier.cluster.arrive.release / wait.acquire), or st.async stores
//   that complete transactions on the receiver's own mbarrier, one phase
//   per use of a slot buffer.
// - The slots are double-buffered by step parity, and parity suffices. A
//   sender writes buffer j & 1 again at step j + 2 only after it has
//   received every warp's step-(j + 1) slot (the barrier, or its mbarrier
//   phase), and every warp writes its step-(j + 1) slot only after it has
//   read the step-j slots (the winner of step j is the centre of step
//   j + 1).
// Past the registers' tiers (N > CL * NT * 32) the points stay in shared
// memory as float4 (x, y, z, distance), and past POINT_BYTES_MAX of them a
// CTA in device memory (the xyz input and a (B, N) scratch): the same
// exchange, with a loop over memory for the pass (PPT = 0).
//
// The main path's form (ops/fps.py: 8 CTAs of 128 threads, push) is the
// fastest of tools/fps_sweep.py's grid on an H100 SXM at 700 W: at 32768
// points and npoint 4096 about 605 ns a step, of which the exchange floor
// is about 365; the cluster barrier costs 300-500 ns a step more than push
// at every form, and 16-CTA clusters or more warps add more exchange than
// they take off the pass.
//
// FLOOR (a template flag, never on the main path) leaves the pass over the
// points out: each step is the exchange alone, each thread's key a
// constant made to depend on the previous winner. Its time over
// npoint - 1 steps is the exchange floor that tools/fps_sweep.py reports.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 227 * 1024;
// shared-memory bytes of a CTA's float4 points on the memory path; past
// them the points stay in device memory (ops/fps.py:_POINT_BYTES_MAX)
constexpr int POINT_BYTES_MAX = 200 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;  // an index that loses every min
constexpr int SLOT_BYTES = 8 + 16;      // (key, index), (x, y, z, 0)

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ float dist2(float x, float y, float z, float cx,
                                       float cy, float cz) {
  return sq_norm(__fsub_rn(x, cx), __fsub_rn(y, cy), __fsub_rn(z, cz));
}

// the packed key of a running distance d (d == -1 or d >= 0, never -0)
__device__ __forceinline__ unsigned key_of(float d) {
  const int bits = __float_as_int(d);
  return bits < 0 ? 0u : (unsigned)bits + 1u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void mbar_arm(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for phase `parity` of an mbarrier. A phase that never completes
// (a lost transaction) traps after ~2^24 polls, seconds where a step takes
// a microsecond, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  for (unsigned polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls > (1u << 24)) __trap();
  }
}

// the first slot with the largest distance: a tree over the slots, the
// lower half winning ties. The distances (-1 or >= 0) order as their bits
// read as signed ints, so each node is one DPX max that also says which
// side won (__vibmax_s32: max(a, b) and a >= b) and one select.
template <int PPT>
__device__ __forceinline__ void thread_best(const float (&d)[PPT],
                                            float& best, int& k_best) {
  int v[PPT], k[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    v[i] = __float_as_int(d[i]);
    k[i] = i;
  }
#pragma unroll
  for (int s = 1; s < PPT; s <<= 1) {
#pragma unroll
    for (int i = 0; i + s < PPT; i += 2 * s) {
      bool low;
      v[i] = __vibmax_s32(v[i], v[i + s], &low);
      k[i] = low ? k[i] : k[i + s];
    }
  }
  best = __int_as_float(v[0]);
  k_best = k[0];
}

// Shared memory: mbar[2] | kslot[2][SLOTS] uint2 | cslot[2][SLOTS] float4
// | pts[] float4 (a CTA's points: PPT * NT, or on the memory path its
// share, none when it spills to device memory)
__host__ __device__ constexpr int header_bytes(int slots) {
  return 16 + 2 * slots * SLOT_BYTES;
}

template <int PPT, int NT, bool PUSH, bool FLOOR>
__global__ void __launch_bounds__(NT, 1)
fps_kernel(const float* __restrict__ xyz,   // (B, N, 3)
           float* __restrict__ gtemp,       // (B, N), or null on chip
           int64_t* __restrict__ out,       // (B, npoint)
           int N, int npoint, int cl_log2) {
  constexpr int W = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int CL = 1 << cl_log2;
  const int SLOTS = CL * W;
  const int CLNT = CL * NT;
  constexpr int NT_LOG2 = NT == 128 ? 7 : (NT == 256 ? 8 : 9);
  const int clnt_log2 = cl_log2 + NT_LOG2;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);
  uint2* kslot = reinterpret_cast<uint2*>(smem + 16);
  float4* cslot = reinterpret_cast<float4*>(smem + 16 + 2 * SLOTS * 8);
  float4* pts = cslot + 2 * SLOTS;

  const unsigned rank = cluster_rank();
  const int b = blockIdx.x >> cl_log2;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int base = (int)rank * NT + tid;  // point g = k * CLNT + base
  const float* gxyz = xyz + (size_t)b * N * 3;
  float* T = gtemp ? gtemp + (size_t)b * N : nullptr;
  const unsigned tx_bytes = (unsigned)(SLOTS * SLOT_BYTES);

  if constexpr (PUSH) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   "mbarrier.init.shared::cta.b64 [%1], 1;"
                   :: "r"(smem_u32(&mbar[0])), "r"(smem_u32(&mbar[1]))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_arm(smem_u32(&mbar[0]), tx_bytes);  // step 2
      mbar_arm(smem_u32(&mbar[1]), tx_bytes);  // step 1
    }
  }

  // load: the skip test once, folded into the starting distance
  constexpr int RP = PPT > 0 ? PPT : 1;
  float px[RP], py[RP], pz[RP], pd[RP];
  int kcount = 0;  // the memory path: this thread's points
  if constexpr (PPT > 0) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int g = k * CLNT + base;
      float x = 0.f, y = 0.f, z = 0.f, d = -1.f;
      if (g < N) {
        x = gxyz[(size_t)g * 3 + 0];
        y = gxyz[(size_t)g * 3 + 1];
        z = gxyz[(size_t)g * 3 + 2];
        d = sq_norm(x, y, z) <= 1e-3f ? -1.f : 1e10f;
      }
      px[k] = x;
      py[k] = y;
      pz[k] = z;
      pd[k] = d;
      pts[k * NT + tid] = make_float4(x, y, z, 0.f);
    }
  } else {
    const int per = (N + CLNT - 1) / CLNT;
    kcount = base < N ? (N - base + CLNT - 1) / CLNT : 0;
    for (int k = 0; k < per; ++k) {
      const int g = k * CLNT + base;
      float x = 0.f, y = 0.f, z = 0.f, d = -1.f;
      if (g < N) {
        x = gxyz[(size_t)g * 3 + 0];
        y = gxyz[(size_t)g * 3 + 1];
        z = gxyz[(size_t)g * 3 + 2];
        d = sq_norm(x, y, z) <= 1e-3f ? -1.f : 1e10f;
      }
      if (T) {
        if (g < N) T[g] = d;
      } else {
        pts[k * NT + tid] = make_float4(x, y, z, d);
      }
    }
  }
  unsigned key0 = 0, g0 = (unsigned)base;
  float4 own0 = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (FLOOR) {
    float best;
    int kb;
    thread_best<RP>(pd, best, kb);
    key0 = key_of(best);
    g0 = (unsigned)(kb * CLNT + base);
    own0 = pts[kb * NT + tid];
  }
  float cx = gxyz[0], cy = gxyz[1], cz = gxyz[2];
  if (rank == 0 && tid == 0) out[(size_t)b * npoint] = 0;
  // every CTA of the cluster runs, its mbarriers and points are ready
  cluster_sync();

  // this lane's publishing addresses in CTA `lane` (lanes < CL), per
  // slot buffer: the (key, index) and coordinate slots, the mbarrier
  const unsigned dst = lane < CL ? (unsigned)lane : 0u;
  uint32_t ka[2], ca[2], bar[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int slot = q * SLOTS + (int)rank * W + warp;
    ka[q] = map_rank(smem_u32(&kslot[slot]), dst);
    ca[q] = map_rank(smem_u32(&cslot[slot]), dst);
    bar[q] = map_rank(smem_u32(&mbar[q]), dst);
  }

  unsigned prev = 0;
  for (int j = 1; j < npoint; ++j) {
    const int p = j & 1;
    unsigned key, gi;
    // the register path's candidate coordinates, from this thread's
    // shared-memory copy, loaded while the warp reduces; the winner's
    // lane shuffles them to the publishing lanes
    float4 own = own0;
    if constexpr (FLOOR) {
      key = key0 ^ (prev & 1u);
      gi = g0;
    } else if constexpr (PPT > 0) {
#pragma unroll
      for (int k = 0; k < RP; ++k)
        pd[k] = fminf(pd[k], dist2(px[k], py[k], pz[k], cx, cy, cz));
      float best;
      int kb;
      thread_best<RP>(pd, best, kb);
      key = key_of(best);
      gi = (unsigned)(kb * CLNT + base);
      own = pts[kb * NT + tid];
    } else {
      float best = -2.f;  // below every distance: the first point wins
      int kb = 0;
      for (int k = 0; k < kcount; ++k) {
        const int g = k * CLNT + base;
        float x, y, z, t;
        if (T) {
          x = gxyz[(size_t)g * 3 + 0];
          y = gxyz[(size_t)g * 3 + 1];
          z = gxyz[(size_t)g * 3 + 2];
          t = T[g];
        } else {
          const float4 q = pts[k * NT + tid];
          x = q.x;
          y = q.y;
          z = q.z;
          t = q.w;
        }
        const float nd = fminf(t, dist2(x, y, z, cx, cy, cz));
        if (T) {
          T[g] = nd;
        } else {
          pts[k * NT + tid].w = nd;
        }
        if (nd > best) {
          best = nd;
          kb = k;
        }
      }
      key = key_of(best);
      gi = (unsigned)(kb * CLNT + base);
    }
    // the warp's candidate
    const unsigned wkey = __reduce_max_sync(FULL, key);
    const unsigned widx = __reduce_min_sync(FULL, key == wkey ? gi : NONE);
    if constexpr (PPT > 0) {  // point g sits in lane g & 31
      own.x = __shfl_sync(FULL, own.x, widx & 31);
      own.y = __shfl_sync(FULL, own.y, widx & 31);
      own.z = __shfl_sync(FULL, own.z, widx & 31);
    }
    if (lane < CL) {  // lane r publishes the warp's candidate to CTA r
      float4 c = own;
      if constexpr (PPT == 0) {  // the memory path reads the winner's
        if (T) {
          c = make_float4(0.f, 0.f, 0.f, 0.f);
          if (widx < (unsigned)N) {
            c.x = gxyz[(size_t)widx * 3 + 0];
            c.y = gxyz[(size_t)widx * 3 + 1];
            c.z = gxyz[(size_t)widx * 3 + 2];
          }
        } else {
          c = pts[(widx >> clnt_log2) * NT + (widx & (NT - 1))];
        }
      }
      const uint32_t kq = p ? ka[1] : ka[0], cq = p ? ca[1] : ca[0];
      if constexpr (PUSH) {
        const uint32_t bq = p ? bar[1] : bar[0];
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
            "[%0], {%1, %2}, [%3];"
            :: "r"(kq), "r"(wkey), "r"(widx), "r"(bq) : "memory");
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
            "[%0], {%1, %2, %3, %4}, [%5];"
            :: "r"(cq), "r"(__float_as_uint(c.x)),
               "r"(__float_as_uint(c.y)), "r"(__float_as_uint(c.z)), "r"(0u),
               "r"(bq) : "memory");
      } else {
        asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};"
                     :: "r"(kq), "r"(wkey), "r"(widx) : "memory");
        asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
                     :: "r"(cq), "f"(c.x), "f"(c.y), "f"(c.z), "f"(0.f)
                     : "memory");
      }
    }
    if constexpr (PUSH) {
      // use (j - 1) >> 1 of buffer p
      mbar_wait(smem_u32(&mbar[p]), ((unsigned)(j - 1) >> 1) & 1u);
    } else {
      cluster_sync();
    }
    // the cluster's winner, from this CTA's own slots
    const uint2* ks = kslot + p * SLOTS;
    unsigned bkey = 0, bidx = NONE;
    for (int s = lane; s < SLOTS; s += 32) {
      const uint2 e = ks[s];
      if (e.x > bkey || (e.x == bkey && e.y < bidx)) {
        bkey = e.x;
        bidx = e.y;
      }
    }
    const unsigned ckey = __reduce_max_sync(FULL, bkey);
    const unsigned cidx = __reduce_min_sync(FULL, bkey == ckey ? bidx : NONE);
    const int ws = (int)(((cidx / NT) & (unsigned)(CL - 1)) * W +
                         ((cidx & (NT - 1)) >> 5));
    const float4 c = cslot[p * SLOTS + ws];
    cx = c.x;
    cy = c.y;
    cz = c.z;
    if constexpr (PUSH) {
      if (tid == 0) mbar_arm(smem_u32(&mbar[p]), tx_bytes);  // step j + 2
    }
    if (rank == 0 && tid == 0) out[(size_t)b * npoint + j] = cidx;
    prev = cidx;
  }
  cluster_sync();  // no CTA exits while others may still write its slots
}

struct Args {
  const float* xyz;
  float* temp;
  int64_t* out;
  int B, N, npoint, cl, cl_log2;
  cudaStream_t stream;
};

// the forms that exist: registers up to 32 points a thread (16 at 512
// threads, whose registers are capped at 128), the memory path, and the
// exchange floor only at the published shape (32768 points over 8 or 16
// CTAs)
template <int PPT, int NT, bool FLOOR>
constexpr bool form_exists() {
  return (PPT == 0 && !FLOOR) ||
         (PPT > 0 && (NT < 512 || PPT <= 16) &&
          (!FLOOR || PPT * NT == 2048 || PPT * NT == 4096));
}

template <int PPT, int NT, bool PUSH, bool FLOOR>
int launch(const Args& a) {
  if constexpr (!form_exists<PPT, NT, FLOOR>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    auto kern = fps_kernel<PPT, NT, PUSH, FLOOR>;
    const int slots = a.cl * (NT / 32);
    long pts = 0;
    if (PPT > 0) {
      if ((long)PPT * a.cl * NT < a.N) return (int)cudaErrorInvalidValue;
      pts = (long)PPT * NT;
    } else if (a.temp == nullptr) {
      const long per = ((long)a.N + a.cl * NT - 1) / (a.cl * NT);
      if (per * NT * 16 > POINT_BYTES_MAX) return (int)cudaErrorInvalidValue;
      pts = per * NT;
    }
    const int smem = header_bytes(slots) + (int)(pts * 16);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;

    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.B * a.cl);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = a.stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // once per form: the attributes, and a cluster that fits the card
    static int ready_smem = -1, ready_cl = -1;
    if (smem != ready_smem || a.cl != ready_cl) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err == cudaSuccess && a.cl > 8)
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      int clusters = 0;
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
      ready_smem = smem;
      ready_cl = a.cl;
    }
    cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a.xyz, a.temp, a.out,
                                         a.N, a.npoint, a.cl_log2);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
}

template <int NT, bool PUSH, bool FLOOR>
int by_ppt(const Args& a, int ppt) {
  switch (ppt) {
    case 0: return launch<0, NT, PUSH, FLOOR>(a);
    case 1: return launch<1, NT, PUSH, FLOOR>(a);
    case 2: return launch<2, NT, PUSH, FLOOR>(a);
    case 4: return launch<4, NT, PUSH, FLOOR>(a);
    case 8: return launch<8, NT, PUSH, FLOOR>(a);
    case 16: return launch<16, NT, PUSH, FLOOR>(a);
    case 32: return launch<32, NT, PUSH, FLOOR>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int NT>
int by_flags(const Args& a, int ppt, int push, int floor) {
  if (push)
    return floor ? by_ppt<NT, true, true>(a, ppt)
                 : by_ppt<NT, true, false>(a, ppt);
  return floor ? by_ppt<NT, false, true>(a, ppt)
               : by_ppt<NT, false, false>(a, ppt);
}

}  // namespace

// One launch: B clusters of `cluster` CTAs (8 or 16) of `threads` threads
// (128, 256 or 512); `ppt` points a thread in registers (1, 2, 4, ..., 32)
// or 0 for the memory path, which keeps the points in shared memory, or
// in device memory when `temp` ((B, N) float scratch) is given; `push`
// picks the st.async transport over the cluster barrier; `floor` the
// exchange alone (its indices are no sample). A form that does not exist,
// that cannot hold N, or whose cluster does not fit the card returns an
// error and launches nothing. N >= 1 (the wrapper checks).
extern "C" int fps_f32(const void* xyz, void* temp, void* out, int B, int N,
                       int npoint, int cluster, int threads, int ppt,
                       int push, int floor, void* stream) {
  if (B <= 0 || npoint <= 0) return (int)cudaGetLastError();
  if (N < 1 || (cluster != 8 && cluster != 16)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{(const float*)xyz, (float*)temp, (int64_t*)out, B, N, npoint,
         cluster, cluster == 8 ? 3 : 4, (cudaStream_t)stream};
  switch (threads) {
    case 128: return by_flags<128>(a, ppt, push, floor);
    case 256: return by_flags<256>(a, ppt, push, floor);
    case 512: return by_flags<512>(a, ppt, push, floor);
    default: return (int)cudaErrorInvalidValue;
  }
}
