"""A cell of the benchmark cut to a size the CPU runs in seconds: the
configuration file's model with small capacities, widths and depth, and
the traffic file with two rooms of 4000 points to a batch."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(voxel_capacity=4096, min_stage_capacity=128, nqueries=64,
             grid_extent=[128, 128, 64], voxel_size=0.1, preenc_npoints=128,
             dec_nlayers=3, dec_dim=32, dec_ffn_dim=32,
             rpe_dim=16, inplanes=8, enc_dim=32, depth=18, num_points=4000)


def tiny_cell(workload: str, **traffic):
    """The cell `workload` of `BENCHMARK.json`."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    conf_file = next(c["file"] for c in bench["configs"]
                     if c["name"] == entry["config"])
    conf = json.loads((ROOT / conf_file).read_text())
    conf["model"].update(SMALL)
    t = json.loads((ROOT / "benchmark" / "traffic"
                    / f"{entry['traffic']}.json").read_text())
    t.update(batch=2, pool_scenes=4, num_points=4000, trace_steps=1,
             check_batches=1)
    t.update(traffic)
    return {"entry": entry, "config": conf, "traffic": t}
