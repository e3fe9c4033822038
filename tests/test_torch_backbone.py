"""The port's sparse backbone and FPN against the JAX package.

The tiny configuration and weights of tests/test_torch_model.py. JAX runs
its own VDETR up to `debug_stop` 3 (backbone and FPN) on the CPU,
through the XLA gather path of its sparse convs; flax's
capture_intermediates returns every stage, up block and the out block,
which the port's modules must reproduce: voxel keys and validity equal,
features within f32 rounding. The `debug_stop` 2 and 3 digests of the
two models agree too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jax_and_port, make_inputs, tiny_config
from vdetr_tpu.models.backbone import FPNOutBlock, FPNUpBlock, SparseResNet
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Each stage is ~10 convolutions deep; f32 sums in other orders differ by
# ~1e-7 relative per op, so 1e-4 relative to the stage's largest feature.
FEAT_TOL = 1e-4


@pytest.fixture(scope="module")
def run():
    cfg = tiny_config()
    jm, variables, port = jax_and_port(cfg)
    inputs = make_inputs(seed=4)

    def capture(mdl, method_name):
        return method_name == "__call__" and isinstance(
            mdl, (SparseResNet, FPNUpBlock, FPNOutBlock))

    def apply(v, i, debug_stop):
        return jm.apply(v, i, train=False, debug_stop=debug_stop,
                        capture_intermediates=capture,
                        mutable=["intermediates"])

    out3, inter = jax.jit(apply, static_argnums=2)(
        variables, jax.tree.map(jnp.asarray, inputs), 3)
    inter = jax.tree.map(np.asarray, inter["intermediates"])
    stages = inter["pre_encoder"]["__call__"][0]
    jax_res = {
        # debug_stop=2's digest, from the same run's captured stages
        "digest2": float(sum(np.asarray(s.features, np.float32).sum()
                             for s in stages)),
        "digest3": float(out3["digest"]), "inter": inter,
    }
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.inference_mode():
        port_res = {"digest2": float(port(tin, debug_stop=2)["digest"]),
                    "digest3": float(port(tin, debug_stop=3)["digest"])}
        grid = _port_grid(port, tin)
        port_res["stages"] = port.pre_encoder(grid)
    return cfg, port, jax_res, port_res


def _port_grid(port, tin):
    from vdetr_tpu_torch.ops.voxelize import voxelize

    c = port.cfg
    return voxelize(tin["point_clouds"], tin["point_clouds"],
                    tin["point_validity"], voxel_size=c.voxel_size,
                    capacity=c.stage_capacities()[0], extent=c.grid_extent)


def _assert_grid(jg, pg, what):
    np.testing.assert_array_equal(pg.keys.numpy(), np.asarray(jg.keys),
                                  err_msg=what)
    np.testing.assert_array_equal(pg.valid.numpy(), np.asarray(jg.valid),
                                  err_msg=what)
    ref = np.asarray(jg.features)
    np.testing.assert_allclose(pg.features.numpy(), ref, rtol=0,
                               atol=FEAT_TOL * max(1.0, np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("stop", [2, 3])
def test_stage_digest_matches_jax(run, stop):
    _, _, jax_res, port_res = run
    np.testing.assert_allclose(port_res[f"digest{stop}"],
                               jax_res[f"digest{stop}"], rtol=1e-5)


def test_every_backbone_stage_matches_jax(run):
    cfg, _, jax_res, port_res = run
    jstages = jax_res["inter"]["pre_encoder"]["__call__"][0]
    assert len(jstages) == len(port_res["stages"]) == cfg.num_stages
    for i, (jg, pg) in enumerate(zip(jstages, port_res["stages"])):
        _assert_grid(jg, pg, f"stage {i + 1}")


def test_fpn_blocks_match_jax(run):
    """Each FPN up block and the out block, fed the JAX stage grids."""
    cfg, port, jax_res, _ = run
    inter = jax_res["inter"]
    stages = [_to_port_grid(g) for g in inter["pre_encoder"]["__call__"][0]]
    x = stages[-1]
    with torch.inference_mode():
        for i in range(cfg.num_stages - 2, -1, -1):
            up = getattr(port, f"up_block_{i + 1}")(x, stages[i])
            _assert_grid(inter[f"up_block_{i + 1}"]["__call__"][0], up,
                         f"up_block_{i + 1}")
            x = stages[i].replace(features=stages[i].features + up.features)
        out = port.out_block_0(x)
    _assert_grid(inter["out_block_0"]["__call__"][0], out, "out_block_0")


def _to_port_grid(jg):
    from vdetr_tpu_torch.ops.voxelize import VoxelGrid

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return VoxelGrid(coords=t(jg.coords), keys=t(jg.keys),
                     features=t(jg.features), valid=t(jg.valid),
                     origin=t(jg.origin), stride=jg.stride,
                     extent=tuple(jg.extent), voxel_size=jg.voxel_size)
