// Stage ablation of the vertex-RPE cross-attention forward (Hopper): a
// probe of kernel C (rpe_attention.cu).
//
// Replaces the TPU probe tools/rpe_ablate.py (its Pallas `kernel`, seven
// cumulative levels of the fused RPE kernel at one grid and one memory
// traffic). Each level is a pairwise function of (query, key):
//   logit[h, q, k] = q[q, h] . K[k] + bias_L[h, q, k], softmax over k,
//   out[q, h] = sum_k p * V[k],
// with no key mask, scale or rotation, as in the tool; bias_L for levels
// 0-5 is the table in rpe_attention_fwd.cuh. Level 6, the full bias, is
// kernel C itself and is launched through rpe_cross_attention_f32.
//
// Design: the levels are rpe_attention_fwd.cuh's kernel body instantiated
// at BIAS_NONE .. BIAS_PLANE_X0, so each keeps C's grid (one block per
// batch and 8 queries), block (four key groups of 128 threads), shared-
// memory footprint (the 128 KB of tables are staged at every level, so
// the occupancy does not change with the level), K/V/key staging and its
// shared x/y quantize of paired corners (the tool's random corners do not
// pair, so the probe times the full quantize); only the per-pair bias
// loop differs. Levels 1-5 nest (each keeps the lower levels' values
// live), so the difference between two of them is the cost of the work
// the higher one adds, inside C's own schedule.
//
// What bounds it on the H100: the QK^T and PV products, 4 hd + 4 flops per
// (head, query, key) on the CUDA cores, and at level 5 four table
// multiply-adds per (pair, corner, head); the index arithmetic is not
// counted (tools/rpe_ablate.py, attention_flops). Built for the published
// decoder's H = 4 heads of width 64 only.

#include "rpe_attention_fwd.cuh"

// Returns cudaErrorInvalidValue (1) for a level outside 0-5, a head count
// other than 4 or a head width other than 64; the Python wrapper checks
// all three first.
extern "C" int rpe_ablate_f32(const void* q, const void* k, const void* v,
                              const void* corners, const void* key_xyz,
                              const void* tables, void* out, int B, int nQ,
                              int nK, int heads, int hd, int n,
                              float log_scale, float max_value, int level,
                              void* stream) {
  if (heads != rpe::H || hd != 64) return (int)cudaErrorInvalidValue;
  if (B <= 0 || nQ <= 0 || nK <= 0) return (int)cudaGetLastError();
  const rpe::TrainOut eval{nullptr, nullptr, nullptr, 0u, 1.f, 0u};
  auto args = [&](auto fn) {
    return fn((const float*)q, (const float*)k, (const float*)v,
              (const float*)corners, nullptr, (const float*)key_xyz,
              (const float*)tables, nullptr, (float*)out, eval, B, nQ, nK, n,
              log_scale, max_value, (cudaStream_t)stream);
  };
  switch (level) {
    case 0: return args(rpe::launch_forward<64, rpe::BIAS_NONE>);
    case 1: return args(rpe::launch_forward<64, rpe::BIAS_DELTAS>);
    case 2: return args(rpe::launch_forward<64, rpe::BIAS_QUANT>);
    case 3: return args(rpe::launch_forward<64, rpe::BIAS_HAT0>);
    case 4: return args(rpe::launch_forward<64, rpe::BIAS_HAT0_ZY>);
    case 5: return args(rpe::launch_forward<64, rpe::BIAS_PLANE_X0>);
    default: return (int)cudaErrorInvalidValue;
  }
}
