"""Run one cell of the benchmark once on one NVIDIA GPU:

    python3 -m benchmark.run --workload scannet_r34.train_b8 --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout that holds `BENCHMARK.json`. Prints one JSON
line last on standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` a `breakdown`, and last
`checks`, each number compared with its limit, which also end standard
error. Exits non-zero, printing no result, without a CUDA device, and if
JAX or the JAX package was loaded. The kernels build into `build/` of the
checkout on a run's first use, and are reused there after.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

def main(argv=None) -> int:
    from benchmark.harness import process_start_time

    t_start = process_start_time()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    root = Path.cwd()
    build = root / "build"
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")

    import torch

    from benchmark import check, harness, spec

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, root, args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.mkdir(exist_ok=True)
    readers = spec.readers(bench, args.workload) if args.trace else {}
    result = harness.execute(
        cell, args.seed, args.seconds, bool(args.trace), "cuda",
        check.limits(args.workload), readers, t_start=t_start,
        trace_dir=build)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
