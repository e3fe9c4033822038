"""Which form of kernel B (furthest-point sampling, `csrc/fps.cu`) is
fastest: the grid of CTAs per cluster x threads per CTA x exchange
transport, timed at the published shape, each form beside its exchange
floor.

    python -m vdetr_tpu_torch.tools.fps_sweep

The shape is the published model's (`VDETRConfig()`): FPS's input on the
main path, the stride-4 level's 32768 voxel centres of synthetic scenes
(`chip_smoke.fps_input`), sampled to 4096 points, for one scene (B = 1)
and for the four rows of an eval batch (B = 4). Per form: ms per launch
(CUDA events, mean of 10), ns a step (over npoint - 1 steps), the indices
that differ from the plain version (0 in a right form), and the exchange
floor at B = 1: the same form with the pass over the points left out
(`ops.fps.fps_launch(floor=True)`), over the same steps. A form whose
cluster the card refuses prints the error. `*` marks the form the wrapper
uses (`ops.fps.CLUSTER`, `THREADS`, `TRANSPORT`). Prints the card's name
and power limit, and one JSON line (`fps_sweep {...}`) last. Needs the
card.
"""

from __future__ import annotations

import json

import torch

CLUSTERS = (8, 16)
THREAD_COUNTS = (128, 256, 512)


def sweep(reps: int = 10):
    """Per form {"cluster", "threads", "transport", "B=1": {ms,
    ns_per_step, mismatches}, "B=4": {...}, "floor_ms",
    "floor_ns_per_step"}, or "error" in place of the times."""
    import chip_smoke as cs
    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.ops.fps import TRANSPORTS, fps_launch, fps_plain
    from vdetr_tpu_torch.tools import time_ms

    dev = torch.device("cuda", 0)
    cfg = VDETRConfig()
    npoint = cfg.preenc_npoints
    steps = npoint - 1
    inputs = {b: cs.fps_input(cs.level_grids(cfg, dev, b)) for b in (1, 4)}
    refs = {b: fps_plain(x, npoint) for b, x in inputs.items()}
    rows = []
    for cluster in CLUSTERS:
        for threads in THREAD_COUNTS:
            for transport in TRANSPORTS:
                row = {"cluster": cluster, "threads": threads,
                       "transport": transport}
                form = dict(cluster=cluster, threads=threads,
                            transport=transport)
                try:
                    for b, xyz in inputs.items():
                        got = fps_launch(xyz, npoint, **form)
                        torch.cuda.synchronize()
                        ms = time_ms(lambda: fps_launch(xyz, npoint, **form),
                                     reps=reps)
                        row[f"B={b}"] = {
                            "ms": ms, "ns_per_step": ms * 1e6 / steps,
                            "mismatches": int((got != refs[b]).sum())}
                    floor = time_ms(lambda: fps_launch(
                        inputs[1], npoint, floor=True, **form), reps=reps)
                    row["floor_ms"] = floor
                    row["floor_ns_per_step"] = floor * 1e6 / steps
                except RuntimeError as e:
                    row["error"] = str(e)
                rows.append(row)
    return rows


def main() -> int:
    from vdetr_tpu_torch import kernels
    from vdetr_tpu_torch.ops import fps
    from vdetr_tpu_torch.tools import card

    if not torch.cuda.is_available():
        print("fps_sweep: needs a CUDA card")
        return 2
    kernels.build_all()
    smi = card()
    print(f"kernel B ms per launch (ns a step), B = 1 and B = 4, indices "
          f"differing from the plain version, and the exchange floor at "
          f"B = 1; * the wrapper's form; card {smi}")
    rows = sweep()
    for r in rows:
        mark = "*" if (r["cluster"], r["threads"], r["transport"]) == (
            fps.CLUSTER, fps.THREADS, fps.TRANSPORT) else " "
        head = (f"{mark} {r['cluster']:2d} CTAs x {r['threads']:3d} "
                f"threads, {r['transport']:7s}")
        if "error" in r:
            print(f"{head}: {r['error']}")
            continue
        one, four = r["B=1"], r["B=4"]
        print(f"{head}: B=1 {one['ms']:.4f} ms ({one['ns_per_step']:.0f} "
              f"ns/step, {one['mismatches']} differ); B=4 {four['ms']:.4f} "
              f"ms ({four['ns_per_step']:.0f} ns/step, {four['mismatches']}"
              f" differ); floor {r['floor_ms']:.4f} ms "
              f"({r['floor_ns_per_step']:.0f} ns/step)")
    print("fps_sweep " + json.dumps({"card": smi, "forms": rows}))
    bad = [r for r in rows if "error" not in r and (
        r["B=1"]["mismatches"] or r["B=4"]["mismatches"])]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
