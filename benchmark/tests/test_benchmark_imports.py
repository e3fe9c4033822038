"""No module the harness runs imports JAX, jaxlib, flax or the JAX
package (top-level names compared whole, so that `vdetr_tpu_torch` is
not taken for `vdetr_tpu`), and the reference imports nothing of the
program either."""

import subprocess
import sys

from tiny import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "vdetr_tpu")


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"
    )], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_run_loads_no_jax():
    code = """
import sys
sys.path.insert(0, 'benchmark/tests')
import torch
from benchmark import harness, spec, calibrate, run
from tiny import tiny_cell
from benchmark.reference import steps
cell = tiny_cell('scannet_r34.eval_b8')
bench = spec.load_benchmark(__import__('pathlib').Path('.'))
import tempfile, os
d = tempfile.mkdtemp()
harness.execute(cell, 5, 0.5, False, 'cpu', {'order_gap': 1.0},
                spec.readers(bench, 'scannet_r34.eval_b8'),
                trace_dir=__import__('pathlib').Path(d))
assert not harness.forbidden_modules()
"""
    top = _loaded(code)
    assert "vdetr_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    top = _loaded("from benchmark.reference import steps, criterion, "
                  "decoder, model, nets, sparse, config\n"
                  "from benchmark import flops, scenes, weights, check")
    assert not top & set(FORBIDDEN + ("vdetr_tpu_torch",))
