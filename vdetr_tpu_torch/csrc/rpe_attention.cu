// Fused vertex-RPE cross-attention forward (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/rpe_attention.py:
// rpe_cross_attention_pallas (_kernel); contract:
// rpe_cross_attention_reference. For query q (H heads, pre-scaled) and a
// single shared K/V head:
//   logit[h, q, k] = q[q, h] . K[k] + sum_{c<8} T_c(quant(R(corner[q, c]
//                                                      - key_xyz[k])))[h]
//   masked keys -> -1e9, softmax over k, out[q, h] = sum_k p * V[k].
// quant(d) = ((sign(d) log2(|d| log_scale + 1) / 3 / max_value + 1) n
// - 1) / 2 per component; T_c is the (d=z, h=y, w=x, H) table of corner
// c sampled trilinearly with zero padding (torch grid_sample,
// align_corners=False: component 0 indexes the last table axis). R is
// the optional object-frame rotation by the query's angle.
//
// Training form (the flash backward, rpe_attention_bwd.cu, consumes it):
// attention dropout after the softmax, p -> p * keep / (1 - rate), on the
// numerator only, as the Pallas kernel applies it; keep comes from the
// counter hash of rpe_common.cuh, which the backward replays. Optional
// outputs: the row log-sum-exp (0 for a batch row whose keys are all
// masked) and the masked biased logits, which the backward reads instead
// of recomputing the bias (the JAX package's train forward stores them
// too, rpe_attention.py:663-673).
//
// The TPU kernel's hat-product P matrices, paired-corner table layout and
// its reliance on corners i, i+4 sharing x/y exist only because Mosaic has
// no dynamic gather. Here each corner is sampled with 8 direct reads from
// the tables in shared memory, for any corners.
//
// What bounds it on the H100: the bias, 8 corners x 8 taps of H floats
// per (query, key) pair read from shared memory after a log2 quantize of
// each delta component (~4x the flops of the QK^T and PV products at H =
// 4, hd = 64), all latency-bound unless many warps are resident. Design:
// one block per (batch, 8 queries); all 8 * n^3 * H table values (128 KB
// at n = 10, H = 4) sit in dynamic shared memory for the block's whole
// sweep over the keys, so one block fits an SM. To keep 16 warps resident
// under that, the block is four key groups of 128 threads (fewer where
// the tables leave less room): group g sweeps key tiles g, g + 4, ... of
// 32 keys (hd = 64) with its own staging and named barriers, so the
// groups drift apart and one group's bias loop overlaps another's flash
// loop. Per tile a group stages K, V and key positions, computes the
// tile's bias for all heads at once (one float4 read per tap when H = 4),
// and four threads per (query, head) row form the logits, run the
// streaming softmax and accumulate P.V in registers. At the end the
// groups' (max, sum, P.V) states merge in group order: deterministic.
// Corners i and i + 4 whose x and y agree bit for bit (a box's bottom and
// top corners, the decoder's case) quantize x and y once for both: 16
// log2 per pair instead of 24; other corners take the full path. K and V
// are read once per tile for all H heads. Keys past nK get weight exactly
// 0; masked keys get -1e9, so a fully masked row averages V uniformly, as
// in the reference.

// The kernel body is rpe_attention_fwd.cuh's, at its full bias level; the
// stage-ablation probe (rpe_ablate.cu) runs the same body at its lower
// levels.

#include "rpe_attention_fwd.cuh"

// Returns cudaErrorInvalidValue (1) for a head count or head width the
// kernel is not built for; the Python wrapper checks both first. lse,
// logits and seed may be null (eval: none of them); a null seed means no
// dropout. key_offset is the global index of key 0 (0 for the dense keys,
// a shard's first key under key sharding), which the dropout hash reads.
extern "C" int rpe_cross_attention_f32(
    const void* q, const void* k, const void* v, const void* corners,
    const void* cossin, const void* key_xyz, const void* tables,
    const void* key_valid, void* out, void* lse, void* logits,
    const void* seed, int B, int nQ, int nK, int heads, int hd, int n,
    float log_scale, float max_value, int rotate, int keep_threshold,
    float drop_scale, int key_offset, void* stream) {
  if (heads != rpe::H) return (int)cudaErrorInvalidValue;
  if (B <= 0 || nQ <= 0 || nK <= 0) return (int)cudaGetLastError();
  const float* cs = rotate ? (const float*)cossin : nullptr;
  const rpe::TrainOut train{(float*)lse, (float*)logits,
                            (const long long*)seed,
                            (uint32_t)keep_threshold, drop_scale,
                            (uint32_t)key_offset};
  auto args = [&](auto fn) {
    return fn((const float*)q, (const float*)k, (const float*)v,
              (const float*)corners, cs, (const float*)key_xyz,
              (const float*)tables, (const uint8_t*)key_valid, (float*)out,
              train, B, nQ, nK, n, log_scale, max_value,
              (cudaStream_t)stream);
  };
  switch (hd) {
    case 8: return args(rpe::launch_forward<8, rpe::BIAS_FULL>);
    case 16: return args(rpe::launch_forward<16, rpe::BIAS_FULL>);
    case 32: return args(rpe::launch_forward<32, rpe::BIAS_FULL>);
    case 64: return args(rpe::launch_forward<64, rpe::BIAS_FULL>);
    case 128: return args(rpe::launch_forward<128, rpe::BIAS_FULL>);
    default: return (int)cudaErrorInvalidValue;
  }
}
