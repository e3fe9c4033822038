// The RPE table contraction alone (Hopper): a probe of kernel C's design.
//
// Replaces the TPU probe tools/dot_micro.py (its Pallas `kern`: per grid
// step nc dots of T[c]^T (M, K) @ P (K, E), summed). Function:
//   out[m, e] = sum_{c < nc} sum_{k < K} T[c, k, m] * P[k, e]
// with T (nc, K, M) and P (K, E) float32. On the TPU this is how the fused
// RPE kernel samples its tables (a hat-product matrix P against the table
// on the MXU); kernel C gathers the taps from shared memory instead. The
// probe answers whether the contraction belongs on the tensor cores.
//
// What bounds it on the H100: P is shared by all corners, so the function
// needs nc K M adds to sum T over c and 2 K M E flops for one product,
// against (nc K M + K E + M E) floats moved: the memory rate at the tool's
// shapes, with the product on the tensor cores (split TF32: three TF32
// MMAs a product, 3 x 2 K M E over 495 TFLOP/s is far below the bytes).
// Design: T is summed over the corners first, in f32 in corner order, and
// the one product Tsum^T P runs on mma.sync m16n8k8 in split TF32
// (tensor_core.cuh: split_tf32, mma_tf32, each chunk's stage chained from
// 0 and added to the sums in f32), the split that A/H/D/I and F's pair
// kernel use. One block of 4 warps per (16 rows of M) x (64 columns of E)
// tile of out, one m16 slab: each warp owns 16 columns. Blocks of one
// slab keep the most blocks in flight (M 40 gives 3 rows of blocks; 3 and
// 8 slabs a block, at M 40 and M 128, were 1.5-2.8x slower in a trial on
// the card, trial not in the repo). The reduction walks K in chunks (64
// deep, else 32, else 16: the deepest that fits, chunk_depth): the
// chunk's T (nc x KC x 16) and P (KC x 64) slices are staged by cp.async
// into a double buffer, the
// next chunk's copies in flight while this one is summed over the corners
// into a shared tile and multiplied. Rows and columns whose tile strides
// are multiples of 32 words plus 8 read fragments free of bank conflicts.
// Ragged K, M and E are zero-filled.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::aligned16;
using tc::cp_async16;
using tc::cp_async4;
using tc::cp_commit;
using tc::cp_wait;
using tc::mma_tf32;
using tc::split_tf32;

constexpr int NT = 128;       // threads: 4 warps
constexpr int NW = 2;         // n8 tiles per warp
constexpr int BN = 4 * NW * 8;  // columns of out per block: 64
constexpr int LDP = BN + 8;   // P tile row stride (words)
constexpr size_t SMEM_MAX = 227 * 1024;

constexpr int MT = 16;        // rows of out per block: one m16 slab
constexpr int LDT = MT + 24;  // summed T tile row stride: 32 words plus 8

// floats of shared memory: two chunks of T (nc x KC x 16) and of P (KC x
// LDP), and the corner-summed tile (KC x LDT)
constexpr size_t smem_floats(int nc, int kc) {
  return 2 * ((size_t)nc * kc * MT + kc * LDP) + kc * LDT;
}

// KC, the reduction depth of a chunk: 64, else 32, else 16, the deepest
// whose chunks fit in shared memory (0: none fits); fewer, deeper chunks
// mean fewer of the block's barrier rounds
inline int chunk_depth(int nc) {
  const int depths[3] = {64, 32, 16};
  for (int kc : depths)
    if (smem_floats(nc, kc) * 4 <= SMEM_MAX) return kc;
  return 0;
}

template <int KC>
__global__ void __launch_bounds__(NT)
dot_micro_kernel(const float* __restrict__ T,  // (nc, K, M)
                 const float* __restrict__ P,  // (K, E)
                 float* __restrict__ out,      // (M, E)
                 int nc, int K, int M, int E, bool t16, bool p16, bool o8) {
  extern __shared__ __align__(16) float smem[];
  const int tslot = nc * KC * MT;        // one chunk of T
  float* sT = smem;                      // 2 x tslot
  float* sP = smem + 2 * tslot;          // 2 x KC x LDP
  float* sS = sP + 2 * KC * LDP;         // KC x LDT: sum_c T
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * MT, e0 = blockIdx.x * BN;
  const int wn = warp * NW * 8;

  // copy chunk `it` into slot `slot`: T[c, k0 + kk, m0 + m] and
  // P[k0 + kk, e0 + e], zero outside K, M and E
  auto load = [&](int it, int slot) {
    const int k0 = it * KC;
    float* st = sT + slot * tslot;
    float* sp = sP + slot * KC * LDP;
    if (t16) {
      for (int i = tid; i < nc * KC * MT / 4; i += NT) {
        const int row = i / (MT / 4), m = (i % (MT / 4)) * 4;
        const int c = row / KC, kk = row % KC;
        const bool p = k0 + kk < K && m0 + m < M;
        const float* src = T + ((size_t)c * K + k0 + kk) * M + m0 + m;
        cp_async16(st + row * MT + m, p ? src : T, p);
      }
    } else {
      for (int i = tid; i < nc * KC * MT; i += NT) {
        const int row = i / MT, m = i % MT;
        const int c = row / KC, kk = row % KC;
        const bool p = k0 + kk < K && m0 + m < M;
        const float* src = T + ((size_t)c * K + k0 + kk) * M + m0 + m;
        cp_async4(st + row * MT + m, p ? src : T, p);
      }
    }
    if (p16) {
      for (int i = tid; i < KC * BN / 4; i += NT) {
        const int kk = i / (BN / 4), e = (i % (BN / 4)) * 4;
        const bool p = k0 + kk < K && e0 + e < E;
        const float* src = P + (size_t)(k0 + kk) * E + e0 + e;
        cp_async16(sp + kk * LDP + e, p ? src : P, p);
      }
    } else {
      for (int i = tid; i < KC * BN; i += NT) {
        const int kk = i / BN, e = i % BN;
        const bool p = k0 + kk < K && e0 + e < E;
        const float* src = P + (size_t)(k0 + kk) * E + e0 + e;
        cp_async4(sp + kk * LDP + e, p ? src : P, p);
      }
    }
  };

  float acc[NW][4];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  const int chunks = (K + KC - 1) / KC;
  load(0, 0);
  cp_commit();
  for (int it = 0; it < chunks; ++it) {
    cp_wait<0>();
    __syncthreads();  // chunk `it` landed; the last chunk's tiles are free
    if (it + 1 < chunks) load(it + 1, (it + 1) & 1);
    cp_commit();
    // sum_c T[c] for the chunk, corner by corner in order
    const float* st = sT + (it & 1) * tslot;
    for (int i = tid; i < KC * MT; i += NT) {
      float s = st[i];
      for (int c = 1; c < nc; ++c) s += st[c * KC * MT + i];
      sS[(i / MT) * LDT + i % MT] = s;
    }
    __syncthreads();
    // this chunk's k8 steps, each product in split TF32, the chunk's sums
    // from 0 then added to acc
    const float* sp = sP + (it & 1) * KC * LDP;
    float part[NW][4];
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      // A = Tsum^T: A[row m][col k] = sS[k][m]
      const float* a0 = sS + (ks * 8 + t) * LDT + g;
      uint32_t ah[4], al[4];
      split_tf32(a0[0], ah[0], al[0]);
      split_tf32(a0[8], ah[1], al[1]);
      split_tf32(a0[4 * LDT], ah[2], al[2]);
      split_tf32(a0[4 * LDT + 8], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const float* b0 = sp + (ks * 8 + t) * LDP + wn + j * 8 + g;
        uint32_t bh[2], bl[2];
        split_tf32(b0[0], bh[0], bl[0]);
        split_tf32(b0[4 * LDP], bh[1], bl[1]);
        if (ks == 0)
          mma_tf32(part[j], al, bh, zero);
        else
          mma_tf32(part[j], al, bh, part[j]);
        mma_tf32(part[j], ah, bl, part[j]);
        mma_tf32(part[j], ah, bh, part[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
  cp_wait<0>();  // no copy may outlive the block's shared memory

  // rows g, g + 8 of the slab; columns 2t, 2t + 1 of each n8 tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + g + 8 * r;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int e = e0 + wn + j * 8 + 2 * t;
      float* o = out + (size_t)m * E + e;
      if (o8 && e + 1 < E) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        if (e < E) o[0] = acc[j][2 * r];
        if (e + 1 < E) o[1] = acc[j][2 * r + 1];
      }
    }
  }
}

template <int KC>
int launch(const float* T, const float* P, float* out, int nc, int K, int M,
           int E, cudaStream_t stream) {
  const size_t smem = smem_floats(nc, KC) * sizeof(float);
  int err = (int)cudaFuncSetAttribute(
      dot_micro_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != 0) return err;
  dim3 grid((E + BN - 1) / BN, (M + MT - 1) / MT);
  dot_micro_kernel<KC><<<grid, NT, smem, stream>>>(
      T, P, out, nc, K, M, E, M % 4 == 0 && aligned16(T),
      E % 4 == 0 && aligned16(P), E % 2 == 0 && ((uintptr_t)out & 7) == 0);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaErrorInvalidValue (1) when no chunk of nc corners fits in
// shared memory (nc above 107).
extern "C" int dot_micro_f32(const void* T, const void* P, void* out, int nc,
                             int K, int M, int E, void* stream) {
  if (nc <= 0 || K <= 0 || M <= 0 || E <= 0) return (int)cudaGetLastError();
  const float* t = (const float*)T;
  const float* p = (const float*)P;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (chunk_depth(nc)) {
    case 64: return launch<64>(t, p, o, nc, K, M, E, s);
    case 32: return launch<32>(t, p, o, nc, K, M, E, s);
    case 16: return launch<16>(t, p, o, nc, K, M, E, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
