// Device code shared by the sparse-convolution kernels (Hopper).
//
// - conv_tile / store_tile: a conv block's gather-GEMM over neighbour
//   rows it has resolved into shared memory. The keyed conv
//   (keyed_conv.cu) resolves them by binary search, the mapped conv
//   (mapped_conv.cu) reads them from a neighbour map; the GEMM is the same.
// - dw_kernel: the weight-gradient GEMM, templated on how a (offset, row)
//   finds its input row: the keyed dW's private map (keyed_conv_dw.cu) or
//   a (B, 27, V) neighbour map (mapped_conv_dw.cu).
// - sum_splits_kernel: adds a kernel's partial sums in a fixed order.
//
// All f32 on the CUDA cores, register-tiled 4 x 4 outputs per thread.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sparse_conv {

constexpr int KV = 27;   // kernel volume
constexpr int NT = 256;  // threads per block: 16 x 16, 4 x 4 outputs each

// conv tiles
constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per stage

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

// acc (this thread's 4 x 4 of the block's 64 rows x 64 output channels
// from n0) += sum over the block's nk offsets of X[s_nbr[k][m]] @
// w[k_begin + k], a row of -1 contributing 0. X is one batch row's
// (V_in, C) features, w the (27, C, Co) weights. Offsets with no hit in
// the tile are skipped. Every thread of the block calls it, after s_nbr
// is written and the block synchronized.
__device__ __forceinline__ void conv_tile(const float* __restrict__ X,
                                          const float* __restrict__ w,
                                          int (*s_nbr)[BM], int k_begin,
                                          int nk, int C, int Co, int n0,
                                          float (&acc)[4][4]) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int k = 0; k < nk; ++k) {
    const int hit = tid < BM && s_nbr[k][tid] >= 0;
    if (!__syncthreads_or(hit)) continue;
    const float* Wk = w + (size_t)(k_begin + k) * C * Co;
    for (int c0 = 0; c0 < C; c0 += BK) {
      for (int i = tid; i < BM * BK; i += NT) {
        const int m = i / BK, kk = i % BK;
        const int r = s_nbr[k][m];
        const int c = c0 + kk;
        As[kk][m] = (r >= 0 && c < C) ? X[(size_t)r * C + c] : 0.f;
      }
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = i / BN, n = i % BN;
        const int c = c0 + kk, col = n0 + n;
        Bs[kk][n] = (c < C && col < Co) ? Wk[(size_t)c * Co + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
      }
      __syncthreads();
    }
  }
}

// out[m0 + row, n0 + col] = acc for the rows < V and columns < Co; out is
// one batch row's (V, Co) output.
__device__ __forceinline__ void store_tile(float* __restrict__ out, int V,
                                           int Co, int m0, int n0,
                                           const float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= V) continue;
    float* o = out + (size_t)row * Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < Co) o[col] = acc[i][j];
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

// Grid of a dw_kernel launch.
inline dim3 dw_grid(int C, int Co, int splits) {
  return dim3(((C + BC - 1) / BC) * ((Co + BO - 1) / BO), KV, splits);
}

// out = sum of the `splits` partials, in split order
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t n,
                                  int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = part[i];
    for (int s = 1; s < splits; ++s) acc += part[(size_t)s * n + i];
    out[i] = acc;
  }
}

inline void sum_splits(const float* part, float* out, size_t n, int splits,
                       cudaStream_t st) {
  sum_splits_kernel<<<264, 512, 0, st>>>(part, out, n, splits);
}

}  // namespace sparse_conv
