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
// against (nc K M + K E + M E) floats moved: 14-28 flops per byte at the
// tool's shapes, around the card's f32 ridge (67 TFLOP/s over 3.35 TB/s,
// 20 per byte), so the memory rate at four of the five and the f32
// CUDA-core rate at K 128, M 128. Like the tool's kernel, this one does
// the product per corner (2 nc K M E flops). Design: a plain tiled f32
// GEMM whose reduction runs over nc * K (no tensor cores yet). One block of 128 threads per
// 32 x 64 tile of out; per 16-deep step the block stages a (16, 32) slice
// of T[c] and a (16, 64) slice of P in shared memory (ragged K, M and E
// masked to zero), and each thread keeps a 4 x 4 block of sums in
// registers over the whole nc * K reduction.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;   // rows of out (M) per block
constexpr int BN = 64;   // columns of out (E) per block
constexpr int BK = 16;   // reduction depth per shared-memory step
constexpr int NT = 128;  // threads: 8 x 16, each 4 x 4 outputs

__global__ void __launch_bounds__(NT)
dot_micro_kernel(const float* __restrict__ T,  // (nc, K, M)
                 const float* __restrict__ P,  // (K, E)
                 float* __restrict__ out,      // (M, E)
                 int nc, int K, int M, int E) {
  __shared__ __align__(16) float sT[BK][BM];
  __shared__ __align__(16) float sP[BK][BN];
  const int tid = threadIdx.x;
  const int tm = tid / (BN / 4), te = tid % (BN / 4);
  const int m0 = blockIdx.y * BM, e0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int c = 0; c < nc; ++c) {
    const float* Tc = T + (size_t)c * K * M;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int i = tid; i < BK * BM; i += NT) {
        const int kk = k0 + i / BM, mm = m0 + i % BM;
        sT[i / BM][i % BM] = kk < K && mm < M ? Tc[(size_t)kk * M + mm] : 0.f;
      }
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = k0 + i / BN, ee = e0 + i % BN;
        sP[i / BN][i % BN] = kk < K && ee < E ? P[(size_t)kk * E + ee] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&sT[kk][tm * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&sP[kk][te * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + te * 4 + j;
      if (e < E) out[(size_t)m * E + e] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int dot_micro_f32(const void* T, const void* P, void* out, int nc,
                             int K, int M, int E, void* stream) {
  if (nc <= 0 || K <= 0 || M <= 0 || E <= 0) return (int)cudaGetLastError();
  dim3 grid((E + BN - 1) / BN, (M + BM - 1) / BM);
  dot_micro_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)T, (const float*)P, (float*)out, nc, K, M, E);
  return (int)cudaGetLastError();
}
