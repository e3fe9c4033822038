"""The harness finds every configuration, traffic mix, per-layer metric
and limit by the name `BENCHMARK.json` gives it, and the file keeps to
the benchmark's contract in its shape."""

import json
import re

import pytest

from benchmark import check, spec
from tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(workload):
    cell = spec.cell(BENCH, ROOT, workload)
    assert cell["config"]["name"] == cell["entry"]["config"]
    assert cell["traffic"]["step"] in ("train", "eval")
    readers = spec.readers(BENCH, workload)
    assert readers and all(callable(r) for r in readers.values())
    lim = check.limits(workload)
    assert lim and all(v >= 0 for v in lim.values())
    ends = {m["name"] for m in spec.metrics(BENCH, "end_to_end", workload)}
    assert "setup_s" in ends and len(ends) >= 2
    for m in spec.metrics(BENCH, "per_layer", workload):
        assert m["moves"] in ends


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024
