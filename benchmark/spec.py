"""Where the harness finds a cell's parts: `BENCHMARK.json` at the root of
the checkout names them, and each is a file of its own under this
directory, found by its name. A later cell or metric is added by adding
files only."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, root: Path, name: str) -> dict:
    """The cell `name`: its entry, its configuration entry and file, and
    its traffic file, read."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(work)}")
    entry = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return {
        "entry": entry,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads(
            (HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
    }


def metrics(bench: dict, kind: str, workload: str) -> List[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics the cell reports:
    those that name it under `workloads`, and those that name no cells."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str) -> Callable:
    """The `read(ctx)` function of per-layer metric `name`, from
    `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(bench: dict, workload: str) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"])
            for m in metrics(bench, "per_layer", workload)}
