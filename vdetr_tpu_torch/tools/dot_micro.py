"""The RPE table contraction alone, on the card.

    python -m vdetr_tpu_torch.tools.dot_micro [--device cuda|cpu]

Counterpart of the JAX package's TPU probe `tools/dot_micro.py`: out (M,
E) = sum_{c < nc} T[c]^T P with T (nc, K, M) and P (K, E) float32, the
contraction with which the TPU's fused RPE kernel samples its tables, at
the tool's five (K, M, E) variants. CUDA tensors launch the Hopper kernel
`csrc/dot_micro.cu` (or raise); CPU tensors take `dot_micro_plain`.

The tool times nt grid steps (one per (32-query, 128-key) tile of a
decoder layer) that all rewrite one block; here one launch is timed and
ms x nt is printed beside it, the per-layer equivalent of the tool's
number. The same function is one PyTorch call, `torch.einsum("ckm,ke->me",
T, P)`: it is timed beside the kernel with TF32 off (the yardstick) and,
named apart, with TF32 on. The port never calls it. On the CPU the entry
point runs the plain version once per variant and prints the shapes: it
times nothing there.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vdetr_tpu_torch import kernels
from vdetr_tpu_torch.tools import bound_ms, card, device_ms, time_ms

# the tool's variants (label, K, M, E): nc 8 corners except the K = 800
# one; nt 1024 tiles per layer at E 4096, 512 at E 8192
VARIANTS = (("K=100 M=40 E=4096", 100, 40, 4096),
            ("K=128 M=40 E=4096", 128, 40, 4096),
            ("K=128 M=128 E=4096", 128, 128, 4096),
            ("K=100 M=40 E=8192", 100, 40, 8192),
            ("K=800 M=40 E=4096 x1", 800, 40, 4096))
NT, NC = 1024, 8


def make_inputs(device="cuda", seed: int = 0, e: int | None = None):
    """Per variant (label, T, P, nt): the tool's draws from one
    RandomState(seed), in its order (`tools/dot_micro.py:67-70`); `e`
    replaces every variant's E (the draws then differ from the tool's)."""
    rng = np.random.RandomState(seed)
    out = []
    for label, K, M, E in VARIANTS:
        nc, nt = (1 if K == 800 else NC), (NT if E == 4096 else NT // 2)
        E = E if e is None else e
        T = rng.rand(nc, K, M).astype(np.float32)
        P = rng.rand(K, E).astype(np.float32)
        out.append((label, torch.from_numpy(T).to(device),
                    torch.from_numpy(P).to(device), nt))
    return out


def dot_micro_plain(T, P):
    """sum_c T[c]^T P, one torch.matmul per corner."""
    out = torch.matmul(T[0].t(), P)
    for c in range(1, T.shape[0]):
        out = out + torch.matmul(T[c].t(), P)
    return out


def dot_micro_library(T, P):
    """The same function as one PyTorch call (the yardstick only)."""
    return torch.einsum("ckm,ke->me", T, P)


def rounding_rtol(T) -> float:
    """Relative tolerance, elementwise, between two float32 orders of the
    sum: with every term positive (the tool's rand inputs) each order is
    within nc K 2^-24 of the exact sum, so two are within twice that."""
    return 2 * T.shape[0] * T.shape[1] * 2.0 ** -24


# csrc/dot_micro.cu stages two chunks of T (nc x KC x 16 floats each) and
# of P (KC x 72), and the corner-summed tile (KC x 40), in shared memory
_SMEM_FLOATS = 227 * 1024 // 4


def kernel_chunk(nc: int) -> int:
    """The kernel's reduction depth per chunk (`chunk_depth`): 64, else
    32, else 16, the deepest whose chunks fit in shared memory; 0 when
    none does."""
    return next((kc for kc in (64, 32, 16)
                 if 2 * (nc * kc * 16 + kc * 72) + kc * 40 <= _SMEM_FLOATS),
                0)


def dot_micro(T, P):
    """out (M, E) = sum_c T[c]^T P for T (nc, K, M), P (K, E) float32:
    T summed over the corners in order, then one product in split TF32
    on the tensor cores (`csrc/dot_micro.cu`)."""
    if not T.is_cuda:
        return dot_micro_plain(T, P)
    nc, K, M = T.shape
    E = P.shape[1]
    if min(nc, K, M, E) <= 0:
        raise ValueError(f"dot_micro: empty operands T {tuple(T.shape)}, "
                         f"P {tuple(P.shape)}")
    kernels.check(T, torch.float32, (nc, K, M), "T")
    kernels.check(P, torch.float32, (K, E), "P")
    if kernel_chunk(nc) == 0:
        raise ValueError(f"dot_micro: {nc} corners do not fit the kernel's "
                         "shared memory")
    out = torch.empty(M, E, dtype=torch.float32, device=T.device)
    kernels.call("dot_micro", T.data_ptr(), P.data_ptr(), out.data_ptr(), nc,
                 K, M, E, torch.cuda.current_stream(T.device).cuda_stream)
    dot_micro.launches += 1
    return out


dot_micro.launches = 0


def kernel_flops(T, P) -> int:
    """2 nc K M E: what the tool's kernel does (one product per corner);
    the tool's TF/s column counts these."""
    nc, K, M = T.shape
    return 2 * nc * K * M * P.shape[1]


def function_flops(T, P) -> int:
    """nc K M + 2 K M E: what the function needs (T summed over the
    corners, then one product), and what `csrc/dot_micro.cu` does."""
    nc, K, M = T.shape
    return nc * K * M + 2 * K * M * P.shape[1]


def variant_bound(T, P):
    """(bound ms, what bounds it): T, P and out moved once; the flops the
    function needs, nc K M to sum T over the corners (P is shared by all
    of them) and 2 K M E for one product, at the f32 CUDA-core rate."""
    nc, K, M = T.shape
    nbytes = (T.numel() + P.numel() + M * P.shape[1]) * 4
    return bound_ms(nbytes, function_flops(T, P))


def _timed_einsum(T, P, reps: int, tf32: bool, timer=time_ms) -> float:
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return timer(lambda: dot_micro_library(T, P), reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def run_variants(cases, reps: int = 20, device_times: bool = True):
    """Each variant timed on the card over `reps` calls: the kernel, the
    plain version and the einsum with TF32 off and on, by CUDA events
    around the calls (`ms`, `plain_ms`, `library_ms`, `library_tf32_ms`:
    host-bound for calls this short) and, with `device_times`, on the
    device (torch.profiler: `device_ms`, `library_device_ms`,
    `library_tf32_device_ms`). The TF/s come from the kernel's device
    time where measured, else its CUDA-event time. Per variant a dict of
    the numbers."""
    rows = []
    for label, T, P, nt in cases:
        b_ms, b_by = variant_bound(T, P)
        row = dict(case=label, nc=T.shape[0], K=T.shape[1], M=T.shape[2],
                   E=P.shape[1], nt=nt, bound_ms=b_ms, bound_by=b_by)
        row["ms"] = time_ms(lambda: dot_micro(T, P), reps)
        row["plain_ms"] = time_ms(lambda: dot_micro_plain(T, P), reps)
        row["library_ms"] = _timed_einsum(T, P, reps, tf32=False)
        row["library_tf32_ms"] = _timed_einsum(T, P, reps, tf32=True)
        if device_times:
            row["device_ms"] = device_ms(lambda: dot_micro(T, P), reps)
            row["library_device_ms"] = _timed_einsum(T, P, reps, False,
                                                     device_ms)
            row["library_tf32_device_ms"] = _timed_einsum(T, P, reps, True,
                                                          device_ms)
        t = row.get("device_ms", row["ms"])
        row["tflops"] = kernel_flops(T, P) / t * 1e-9
        row["function_tflops"] = function_flops(T, P) / t * 1e-9
        rows.append(row)
    return rows


def format_rows(rows):
    lines = []
    for r in rows:
        dev = (f", device {r['device_ms']:.4f} ms" if "device_ms" in r
               else "")
        lib = ("" if "library_device_ms" not in r else
               f" (device {r['library_device_ms']:.4f})")
        lib32 = ("" if "library_tf32_device_ms" not in r else
                 f" (device {r['library_tf32_device_ms']:.4f})")
        lines.append(
            f"{r['case']:22s} nc={r['nc']} {r['ms']:.4f} ms{dev}: "
            f"{r['tflops']:6.2f} TF/s of the tool's 2 nc K M E, "
            f"{r['function_tflops']:6.2f} of the function's nc K M + 2 K M "
            f"E; x nt={r['nt']}: {r['ms'] * r['nt']:.2f} ms; bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}); plain "
            f"{r['plain_ms']:.4f} ms; einsum TF32 off {r['library_ms']:.4f}"
            f" ms{lib}, TF32 on {r['library_tf32_ms']:.4f} ms{lib32}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dot_micro: no CUDA device (--device cpu runs the "
                         "plain version)")
    cases = make_inputs(args.device)
    if args.device == "cpu":
        print("device: cpu, the plain version once (no timing)")
        for label, T, P, _ in cases:
            print(f"{label:22s} nc={T.shape[0]} out "
                  f"{tuple(dot_micro(T, P).shape)}")
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card()}")
    for line in format_rows(run_variants(cases)):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
