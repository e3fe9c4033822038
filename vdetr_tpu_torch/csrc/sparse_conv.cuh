// Device code shared by the sparse-convolution kernels (Hopper).
//
// - conv_tile / store_tile: a conv block's gather-GEMM over neighbour
//   rows it has resolved into shared memory, on the tensor cores in
//   split TF32 (three m16n8k8 MMAs per f32 product) behind a cp.async
//   ring. The keyed conv (keyed_conv.cu) resolves the rows by binary
//   search, the mapped conv (mapped_conv.cu) reads them from a neighbour
//   map; the GEMM is the same, so the two are bit-equal.
// - dw_kernel: the weight-gradient GEMM, templated on how a (offset, row)
//   finds its input row: the keyed dW's private map (keyed_conv_dw.cu) or
//   a (B, 27, V) neighbour map (mapped_conv_dw.cu).
// - conv_sum_splits_kernel / dw_sum_splits_kernel: add a kernel's
//   partial sums in a fixed order.
//
// dw_kernel is f32 on the CUDA cores, register-tiled 4 x 4 outputs per
// thread.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sparse_conv {

constexpr int KV = 27;   // kernel volume
constexpr int NT = 256;  // dW threads per block: 16 x 16, 4 x 4 outputs each

// conv tiles (conv_tile): CONV_NT threads, 4 warps of 32 x 32 outputs;
// the input channels per stage and the ring depth are template arguments
constexpr int CONV_NT = 128;
constexpr int BM = 64;      // query rows per block
constexpr int BN = 64;      // output channels per block
constexpr int BS = BN + 8;  // Bs row stride: B fragments conflict-free

// dW tiles
constexpr int BC = 64;   // input channels per block (dW rows)
constexpr int BO = 64;   // output channels per block (dW columns)
constexpr int BR = 16;   // voxel rows per stage

__device__ __forceinline__ int lower_bound(const int* keys, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// --- tensor-core pieces of conv_tile (PTX, sm_80 and later) ---

// 16 bytes global -> shared, in flight until cp_wait; zero-filled when
// !pred (src-size 0: nothing is read, src need only be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), both rounded to
// nearest: hi * hi' + hi * lo' + lo * hi' carries ~21 bits of each
// operand, the f32 product's ~24 less the dropped lo * lo' (~2^-22)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d = a (16 x 8, row-major) . b (8 x 8, column-major) + c, TF32 in, f32
// out; fragments as PTX lays them out for m16n8k8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// A thread's share of a 64 x 64 conv tile: warp w holds rows 32 (w & 1)
// + 16 mi + {g, g + 8} and columns 32 (w >> 1) + 8 ni + {2t, 2t + 1},
// g = lane / 4, t = lane % 4, as the m16n8 accumulator fragments.
struct ConvAcc {
  float c[2][4][4];
};

// acc += sum over the block's nk offsets of X[s_nbr[k][m]] @ w[k_begin +
// k], a row of -1 contributing 0. X is one batch row's (V_in, C)
// features, w the (27, C, Co) weights. Offsets with no hit in the tile
// are skipped. The K loop runs over (offset with a hit, BK-channel chunk)
// through a STAGES-deep cp.async ring: gathered rows and the weight tile
// land in shared memory while the tensor cores work on an earlier stage,
// each f32 operand split into two TF32 halves (split_tf32) and multiplied
// in three m16n8k8 MMAs; each stage's products are summed apart and added
// to the f32 accumulators with rounding f32 adds. a16 / b16: X rows /
// weight rows may be copied in 16-byte pieces (C resp. Co a multiple of
// 4, bases 16-byte aligned), otherwise in 4-byte copies (the stem's C = 3
// rows are 12 bytes). A chunk multiplies its channels rounded up to 8,
// one k8 step per 8. Every thread of the block calls it, after s_nbr is
// written and the block synchronized.
template <int BK, int STAGES>
__device__ __forceinline__ void conv_tile(const float* __restrict__ X,
                                          const float* __restrict__ w,
                                          int (*s_nbr)[BM], int k_begin,
                                          int nk, int C, int Co, int n0,
                                          bool a16, bool b16,
                                          ConvAcc& acc) {
  constexpr int AS = BK + 4;  // As row stride: A fragments conflict-free
  __shared__ __align__(16) float As[STAGES][BM][AS];
  __shared__ __align__(16) float Bs[STAGES][BK][BS];
  __shared__ int s_koff[KV];
  __shared__ int s_nkh;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;

  // the offsets with a hit in the tile, in order
  for (int k = warp; k < nk; k += CONV_NT / 32) {
    const bool hit = s_nbr[k][lane] >= 0 || s_nbr[k][lane + 32] >= 0;
    s_koff[k] = __any_sync(0xffffffffu, hit) ? 1 : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < nk; ++k)
      if (s_koff[k]) s_koff[n++] = k;
    s_nkh = n;
  }
  __syncthreads();
  const int nchunks = (C + BK - 1) / BK;
  const int total = s_nkh * nchunks;
  // the channels K step `it` multiplies: its chunk's, rounded up to 8
  auto width = [&](int it) {
    return min(BK, (C - (it % nchunks) * BK + 7) / 8 * 8);
  };

  // issue the copies of K step `it` into ring slot `slot`
  auto load = [&](int it, int slot) {
    const int kk = s_koff[it / nchunks];
    const int c0 = (it % nchunks) * BK;
    const int kw = width(it);
    const int* nb = s_nbr[kk];
    if (a16) {
      for (int i = tid; i < BM * kw / 4; i += CONV_NT) {
        const int m = i / (kw / 4), c = (i % (kw / 4)) * 4;
        const int r = nb[m];
        const bool p = r >= 0 && c0 + c < C;
        cp_async16(&As[slot][m][c], p ? X + (size_t)r * C + c0 + c : X, p);
      }
    } else {
      for (int i = tid; i < BM * kw; i += CONV_NT) {
        const int m = i / kw, c = i % kw;
        const int r = nb[m];
        const bool p = r >= 0 && c0 + c < C;
        cp_async4(&As[slot][m][c], p ? X + (size_t)r * C + c0 + c : X, p);
      }
    }
    const float* Wk = w + ((size_t)(k_begin + kk) * C + c0) * Co + n0;
    if (b16) {
      for (int i = tid; i < kw * BN / 4; i += CONV_NT) {
        const int c = i / (BN / 4), n = (i % (BN / 4)) * 4;
        const bool p = c0 + c < C && n0 + n < Co;
        cp_async16(&Bs[slot][c][n], p ? Wk + (size_t)c * Co + n : w, p);
      }
    } else {
      for (int i = tid; i < kw * BN; i += CONV_NT) {
        const int c = i / BN, n = i % BN;
        const bool p = c0 + c < C && n0 + n < Co;
        cp_async4(&Bs[slot][c][n], p ? Wk + (size_t)c * Co + n : w, p);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s, s);
    cp_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // step `it` landed; step it - 1's slot is free
    if (it + STAGES - 1 < total)
      load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_commit();
    const int slot = it % STAGES;
    const int nks = width(it) / 8;
    // the stage's products go to a partial sum started at 0, added to acc
    // with f32 adds: the tensor cores' own accumulation does not round to
    // nearest, so a long chain of MMAs into one large sum drifts
    float part[2][4][4];
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      if (ks == nks) break;
      const int kb = ks * 8;
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* a0 = &As[slot][wm + mi * 16 + g][kb + t];
        const float* a1 = a0 + 8 * AS;
        split_tf32(a0[0], ah[mi][0], al[mi][0]);
        split_tf32(a1[0], ah[mi][1], al[mi][1]);
        split_tf32(a0[4], ah[mi][2], al[mi][2]);
        split_tf32(a1[4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* b0 = &Bs[slot][kb + t][wn + ni * 8 + g];
        split_tf32(b0[0], bh[ni][0], bl[ni][0]);
        split_tf32(b0[4 * BS], bh[ni][1], bl[ni][1]);
      }
      // the small cross terms first, then hi * hi
      const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float(&p)[4] = part[mi][ni];
          if (ks == 0)
            mma_tf32(p, al[mi], bh[ni], zero);
          else
            mma_tf32(p, al[mi], bh[ni], p);
          mma_tf32(p, ah[mi], bl[ni], p);
          mma_tf32(p, ah[mi], bh[ni], p);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.c[mi][ni][e] += part[mi][ni][e];
  }
  cp_wait<0>();  // no copy may outlive the block's shared memory
}

// out[m0 + row, n0 + col] = acc for the rows < V and columns < Co; out is
// one batch row's (V, Co) output.
__device__ __forceinline__ void store_tile(float* __restrict__ out, int V,
                                           int Co, int m0, int n0,
                                           const ConvAcc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mi * 16 + g + 8 * h;
      if (row >= V) continue;
      float* o = out + (size_t)row * Co;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t;
        if (col < Co) o[col] = acc.c[mi][ni][2 * h];
        if (col + 1 < Co) o[col + 1] = acc.c[mi][ni][2 * h + 1];
      }
    }
}

// dW[k] (or the split's partial) = sum over rows r in the split of
// feats[src]^T dout[r], src = nbr(k, r) the global input row (-1: none).
// Grid: (C tiles x Co tiles, 27, splits). feats (B * V_in, C), dout
// (rows, Co), dw (splits, 27, C, Co). rows_per_split is a multiple of BR.
template <class Map>
__global__ void __launch_bounds__(NT)
dw_kernel(const float* __restrict__ feats, const float* __restrict__ dout,
          Map nbr, float* __restrict__ dw, int rows, int C, int Co,
          int rows_per_split) {
  __shared__ __align__(16) float As[BR][BC + 4];
  __shared__ __align__(16) float Bs[BR][BO + 4];
  __shared__ int s_src[BR];

  const int n_otiles = (Co + BO - 1) / BO;
  const int c0 = (blockIdx.x / n_otiles) * BC;
  const int o0 = (blockIdx.x % n_otiles) * BO;
  const int k = blockIdx.y;
  const int split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += BR) {
    int hit = 0;
    if (tid < BR) {
      const int r = r0 + tid;
      const int src = r < r_end ? nbr(k, r) : -1;
      s_src[tid] = src;
      hit = src >= 0;
    }
    if (!__syncthreads_or(hit)) continue;
    for (int i = tid; i < BR * BC; i += NT) {
      const int r = i / BC, c = i % BC;
      const int src = s_src[r];
      As[r][c] = (src >= 0 && c0 + c < C) ? feats[(size_t)src * C + c0 + c]
                                          : 0.f;
    }
    for (int i = tid; i < BR * BO; i += NT) {
      const int r = i / BO, o = i % BO;
      Bs[r][o] = (s_src[r] >= 0 && o0 + o < Co)
                     ? dout[(size_t)(r0 + r) * Co + o0 + o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

  float* out = dw + ((size_t)split * KV + k) * C * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < Co) out[(size_t)c * Co + o] = acc[i][j];
    }
  }
}

// dw_kernel's view of the keyed dW's private map: (27, rows) global input
// rows, -1 for none.
struct FlatMap {
  const int* nbr;
  int rows;
  __device__ __forceinline__ int operator()(int k, int r) const {
    return nbr[(size_t)k * rows + r];
  }
};

// dw_kernel's view of a (B, 27, V) neighbour map of local rows, V_in (or
// anything outside [0, V_in)) for a miss: row r = b * V + v.
struct BatchMap {
  const int* nbr;
  int V, V_in;
  __device__ __forceinline__ int operator()(int k, int r) const {
    const int b = r / V, v = r - b * V;
    const int i = nbr[((size_t)b * KV + k) * V + v];
    return (i >= 0 && i < V_in) ? b * V_in + i : -1;
  }
};

// whether a pointer may be read in 16-byte pieces
inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Grid of a dw_kernel launch.
inline dim3 dw_grid(int C, int Co, int splits) {
  return dim3(((C + BC - 1) / BC) * ((Co + BO - 1) / BO), KV, splits);
}

// out = sum of the `splits` partials, in split order; two kernels of one
// body, so that a profile tells the conv's sums (A, H) from the weight
// gradient's (D, I)
__device__ __forceinline__ void sum_splits_body(const float* __restrict__ part,
                                                float* __restrict__ out,
                                                size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = part[i];
    for (int s = 1; s < splits; ++s) acc += part[(size_t)s * n + i];
    out[i] = acc;
  }
}

__global__ void conv_sum_splits_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, size_t n,
                                       int splits) {
  sum_splits_body(part, out, n, splits);
}

__global__ void dw_sum_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, size_t n,
                                     int splits) {
  sum_splits_body(part, out, n, splits);
}

inline void conv_sum_splits(const float* part, float* out, size_t n,
                            int splits, cudaStream_t st) {
  conv_sum_splits_kernel<<<264, 512, 0, st>>>(part, out, n, splits);
}

inline void dw_sum_splits(const float* part, float* out, size_t n,
                          int splits, cudaStream_t st) {
  dw_sum_splits_kernel<<<264, 512, 0, st>>>(part, out, n, splits);
}

}  // namespace sparse_conv
