// Keyed 3x3x3 sparse convolution over sorted packed voxel keys (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/sparse_conv_keyed.py:keyed_conv
// (_keyed_conv_kernel). Function, per batch row b, query row v, offset k:
//   key = pack(q[v] + off[k]) with pack_keys' bounds check (out of range
//         is a miss), off[k] x-major / z-fastest in {-1,0,1}^3;
//   nbr = binary search of key in the sorted keys of the input table;
//   out[v] = sum_k feats[nbr] @ W[k]   (a miss contributes 0), f32.
// Queries are the table's own coords (submanifold) or 2*out_coords in the
// input lattice (stride 2); invalid query rows give 0.
//
// The TPU kernel's window anchors, one-hot selection matmuls and fix-up
// plans exist only because Mosaic has no dynamic row gather; here a block
// gathers its neighbour rows directly.
//
// What bounds it on the H100: f32 multiply-adds on the CUDA cores (the
// 512-wide convs dominate; ~27*C*Co*2 flop per output row), then the
// gather of neighbour rows from L2/HBM. Design: one block per 64 query
// rows x 64 output channels x a share of the 27 offsets; the block
// resolves its neighbour rows once (binary searches, all threads), skips
// offsets with no hit in the tile and tiles with no valid row, and runs a
// 64x64x16 register-tiled f32 GEMM over gathered rows staged in shared
// memory. The deep levels have few live 64-row tiles (629 valid voxels
// of 4096 in stage 4 at batch 1), so there the caller splits the offsets
// over `splits` blocks, which write partial sums that a second kernel
// adds in a fixed order. No tensor cores yet: the operands are f32,
// matching the plain version's f32 matmul.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per stage
constexpr int NT = 256;  // threads per block: 16 x 16, 4x4 outputs each
constexpr int KV = 27;   // kernel volume

__device__ __forceinline__ int lower_bound(const int* keys, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(NT)
keyed_conv_kernel(const float* __restrict__ feats,   // (B, V_in, C)
                  const int* __restrict__ in_keys,   // (B, V_in) ascending
                  const int* __restrict__ q_coords,  // (B, V, 3)
                  const uint8_t* __restrict__ q_valid,  // (B, V)
                  const float* __restrict__ w,       // (27, C, Co)
                  float* __restrict__ out,           // (splits, B, V, Co)
                  int V_in, int V, int C, int Co, int gx, int gy, int gz,
                  int splits) {
  __shared__ int s_nbr[KV][BM];
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int B = gridDim.z / splits;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int k_begin = split * KV / splits;
  const int nk = (split + 1) * KV / splits - k_begin;
  out += (size_t)split * B * V * Co;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int* keys = in_keys + (size_t)b * V_in;
  const float* X = feats + (size_t)b * V_in * C;

  // resolve the tile's neighbour rows for its offsets (-1 = miss)
  int live = 0;
  for (int i = tid; i < nk * BM; i += NT) {
    const int kk = i / BM, m = i % BM;
    const int k = k_begin + kk;
    const int row = m0 + m;
    int idx = -1;
    if (row < V && q_valid[(size_t)b * V + row]) {
      live = 1;
      const int* qc = q_coords + ((size_t)b * V + row) * 3;
      const int x = qc[0] + k / 9 - 1;
      const int y = qc[1] + (k / 3) % 3 - 1;
      const int z = qc[2] + k % 3 - 1;
      // bounds check first: an out-of-range neighbour must not alias a
      // key of the next x or y slice
      if (x >= 0 && x < gx && y >= 0 && y < gy && z >= 0 && z < gz) {
        const int key = (x * gy + y) * gz + z;
        const int pos = lower_bound(keys, V_in, key);
        if (pos < V_in && keys[pos] == key) idx = pos;
      }
    }
    s_nbr[kk][m] = idx;
  }
  live = __syncthreads_or(live);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (live) {
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= V) continue;
    float* o = out + ((size_t)b * V + row) * Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < Co) o[col] = acc[i][j];
    }
  }
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

}  // namespace

// scratch: (splits, B, V, Co) floats when splits > 1, else unused.
extern "C" int keyed_conv_f32(const void* feats, const void* in_keys,
                              const void* q_coords, const void* q_valid,
                              const void* weights, void* out, void* scratch,
                              int B, int V_in, int V, int C, int Co, int gx,
                              int gy, int gz, int splits, void* stream) {
  if (splits < 1 || splits > KV) return (int)cudaErrorInvalidValue;
  if (B > 0 && V > 0 && Co > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    float* dst = splits > 1 ? (float*)scratch : (float*)out;
    dim3 grid((V + BM - 1) / BM, (Co + BN - 1) / BN, B * splits);
    keyed_conv_kernel<<<grid, NT, 0, st>>>(
        (const float*)feats, (const int*)in_keys, (const int*)q_coords,
        (const uint8_t*)q_valid, (const float*)weights, dst, V_in, V, C, Co,
        gx, gy, gz, splits);
    if (splits > 1) {
      const size_t n = (size_t)B * V * Co;
      sum_splits_kernel<<<264, 512, 0, st>>>(dst, (float*)out, n, splits);
    }
  }
  return (int)cudaGetLastError();
}
