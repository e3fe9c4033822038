"""The port's probes of kernel C against the JAX package's TPU probes.

`tools/rpe_ablate.py` (the stage ablation of the fused RPE kernel) and
`tools/dot_micro.py` (the bare table contraction) keep their Pallas
kernels as closures inside `main()`. Each closure, and the tool's `run`
that calls it with its BlockSpecs, is taken out of the file with `ast`,
unchanged, and executed with the tool's constants bound in its namespace
and `pallas_call` in interpret mode. On the CPU the port's wrappers take
their plain versions, which are held to that code; the Hopper kernels are
held to the plain versions by tests/test_torch_cuda.py and chip_smoke.py.
"""

import ast
import functools
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vdetr_tpu.ops.rpe_attention import (_hat, _quantize,
                                         rpe_cross_attention_reference)
from vdetr_tpu_torch.ops.rpe_attention import rpe_cross_attention_plain
from vdetr_tpu_torch.tools import dot_micro as port_dm
from vdetr_tpu_torch.tools import rpe_ablate as port_ra
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOOLS = Path(__file__).resolve().parents[1] / "tools"
# the tool's tiles at a small size: a (1, 2, 2) grid of (32, 128) tiles
NQ, NK, TQ, TK = 64, 256, 32, 128
# pallas with the interpret flag; the rest of the tool's `pl` as it is
PL_INTERPRET = types.SimpleNamespace(
    pallas_call=functools.partial(pl.pallas_call, interpret=True),
    BlockSpec=pl.BlockSpec, program_id=pl.program_id,
    num_programs=pl.num_programs, when=pl.when)


def tool_namespace(tool: str, names, **bound):
    """Exec the nested functions `names` of the tool's main() in a
    namespace holding `bound`; returns the namespace."""
    src = (TOOLS / tool).read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    ns = dict(jax=jax, jnp=jnp, pl=PL_INTERPRET, pltpu=pltpu,
              functools=functools, **bound)
    found = [n for n in ast.walk(main)
             if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in found) == sorted(names)
    for node in found:
        exec(textwrap.dedent(ast.get_source_segment(src, node)), ns)
    return ns


def tool_rpe_inputs(scale=1.0):
    """The tool's draws (tools/rpe_ablate.py:137-144) in its layouts at
    the small size; `scale` multiplies the coordinates, as the port's
    make_inputs does."""
    B, H, hd, n = 1, 4, 64, 10
    rng = np.random.RandomState(0)
    q = rng.randn(B, H, NQ, hd).astype(np.float32) * 0.1
    k = rng.randn(B, NK, hd).astype(np.float32) * 0.1
    v = rng.randn(B, NK, hd).astype(np.float32)
    corners = rng.rand(B, NQ, 24).astype(np.float32) * 6 * np.float32(scale)
    kxyz = rng.rand(B, 3, NK).astype(np.float32) * 6 * np.float32(scale)
    tables = rng.randn(8, n * n, n * H).astype(np.float32)
    return dict(q=q, k=k, v=v, corners=corners, kxyz=kxyz, tables=tables)


def tool_rpe_level(level: int, scale: float):
    """The tool's own kernel at `level`, (B, nQ, H, hd) as the port's."""
    arrays = {k: jnp.asarray(a) for k, a in tool_rpe_inputs(scale).items()}
    ns = tool_namespace(
        "rpe_ablate.py", ("kernel", "run"), B=1, nQ=NQ, nK=NK, H=4, hd=64,
        n=10, TQ=TQ, TK=TK, E=TQ * TK, NEG_INF=-1e9, _quantize=_quantize,
        _hat=_hat, **arrays)
    return np.asarray(ns["run"](level)).transpose(0, 2, 1, 3)


# levels 1 and 2 saturate the softmax at the tool's coordinates (mean top
# probability 0.99 and 0.89): a second input with the coordinates scaled
# down keeps them soft (0.036 and 0.071), so more than the argmax is held
CASES = [(lv, 1.0) for lv in range(7)] + [(1, 0.05), (2, 3e-4)]


@pytest.mark.parametrize("level,scale", CASES,
                         ids=[f"L{lv}-x{s:g}" for lv, s in CASES])
def test_plain_ablation_matches_tool_kernel(level, scale):
    inputs = port_ra.make_inputs(NQ, NK, "cpu", scale=scale)
    got = port_ra.rpe_ablate(level, *inputs).numpy()
    want = tool_rpe_level(level, scale)
    tol = port_ra.rounding_tol(level, *inputs)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert np.abs(got).max() > 0.1  # not an all-zero average


def test_level6_matches_reference_and_plain_rpe():
    """Level 6 is kernel C's function: the JAX reference and the port's
    plain RPE attention, with no mask and no rotation."""
    inputs = port_ra.make_inputs(NQ, NK, "cpu")
    q, k, v, corners, key_xyz, tables = inputs
    got = port_ra.rpe_ablate_plain(6, *inputs).numpy()
    tol = port_ra.rounding_tol(6, *inputs)
    ref = rpe_cross_attention_reference(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, corners)),
        jnp.zeros((1, NQ)), jnp.asarray(key_xyz.numpy()),
        jnp.asarray(tables.numpy()), None, log_scale=512.0, max_value=4.0,
        rotate=False)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=tol)
    plain = rpe_cross_attention_plain(q, k, v, corners, None, key_xyz,
                                      tables, None, log_scale=512.0,
                                      max_value=4.0).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=tol)


@pytest.mark.parametrize("variant", range(len(port_dm.VARIANTS)),
                         ids=[v[0].split(" E=")[0] for v in port_dm.VARIANTS])
def test_plain_contraction_matches_tool_kern(variant):
    """At E 512, one grid step of the tool's kernel; the tolerance is
    `rounding_rtol`'s bound on two orders of a positive sum."""
    label, T, P, _ = port_dm.make_inputs("cpu", e=512)[variant]
    nc, K, M = T.shape
    ns = tool_namespace("dot_micro.py", ("kern", "run"), nc=nc, nt=1, K=K,
                        M=M, E=512)
    want = np.asarray(ns["run"](jnp.asarray(T.numpy()),
                                jnp.asarray(P.numpy())))
    got = port_dm.dot_micro(T, P).numpy()
    rtol = port_dm.rounding_rtol(T)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    np.testing.assert_allclose(port_dm.dot_micro_library(T, P).numpy(),
                               want, rtol=rtol, atol=0)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    inputs = port_ra.make_inputs(16, 64, "cpu")
    before = port_ra.rpe_ablate.launches
    for level in range(7):
        torch.testing.assert_close(port_ra.rpe_ablate(level, *inputs),
                                   port_ra.rpe_ablate_plain(level, *inputs),
                                   rtol=0, atol=0)
    assert port_ra.rpe_ablate.launches == before
    with pytest.raises(ValueError):
        port_ra.rpe_ablate(7, *inputs)
    T, P = torch.rand(3, 5, 4), torch.rand(5, 6)
    before = port_dm.dot_micro.launches
    torch.testing.assert_close(port_dm.dot_micro(T, P),
                               sum(T[c].t() @ P for c in range(3)))
    assert port_dm.dot_micro.launches == before


def test_level0_yardstick_is_plain_level0():
    """SDPA at scale 1, the yardstick chip_smoke times beside level 0,
    computes level 0's function."""
    inputs = port_ra.make_inputs(NQ, NK, "cpu")
    got = port_ra.flash_library(*port_ra.sdpa_layout(*inputs[:3]))
    torch.testing.assert_close(got.transpose(1, 2),
                               port_ra.rpe_ablate_plain(0, *inputs), rtol=0,
                               atol=port_ra.rounding_tol(0, *inputs))


def test_entry_points_run_on_the_cpu(capsys, monkeypatch):
    """At a small size (the tools' sizes patched): the plain versions once
    per level and variant, their shapes printed, no timing."""
    monkeypatch.setattr(port_ra, "NQ", 16)
    monkeypatch.setattr(port_ra, "NK", 64)
    assert port_ra.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert all(f"{label:26s} out (1, 16, 4, 64)" in out
               for label in port_ra.LABELS)
    assert " ms" not in out
    monkeypatch.setattr(port_dm, "make_inputs",
                        functools.partial(port_dm.make_inputs, e=64))
    assert port_dm.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert all(f"{v[0]:22s} nc={1 if v[1] == 800 else 8} out ({v[2]}, 64)"
               in out for v in port_dm.VARIANTS)
    assert " ms" not in out
