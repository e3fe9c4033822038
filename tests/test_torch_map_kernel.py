"""The port's neighbour map (kernel G's plain version,
`vdetr_tpu_torch/ops/map_kernel.py`) against the JAX package's two maps,
and the rulebook that kernels D and I compact a map into (`dw_rulebook`)
against JAX's map.

The map must be BIT-IDENTICAL to JAX's: a wrong row silently drops or
corrupts a conv tap. References, on the CPU: `sparse_conv._zrun_neighbors`
(the map the JAX package builds off the TPU) and `map_kernel.stencil_map`
in interpret mode (the TPU kernel with its exact fix-up patch), on the
layouts of tests/test_map_kernel.py: clustered sites at B = 2, the comb
wall whose rows the TPU kernel must patch, isolated sites; submanifold
(a level's own sites) and stride 2 (queries 2 * out_coords).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_window_conv import _comb_wall_grid, _grid
from vdetr_tpu.ops import map_kernel as jmk
from vdetr_tpu.ops import sparse_conv as jsc
from vdetr_tpu.ops.voxelize import downsample_grid as jax_downsample
from vdetr_tpu.ops.voxelize import voxelize as jax_voxelize
from vdetr_tpu_torch.ops import sparse_conv as tsc
from vdetr_tpu_torch.ops.map_kernel import kernel_map, neighbour_map
from vdetr_tpu_torch.ops.sparse_conv_kernel import (DW_PLAN,
                                                    dw_blocks_per_sm,
                                                    dw_dense, dw_row_splits,
                                                    dw_tiles,
                                                    dw_rulebook,
                                                    mapped_conv_dw_plain)
from vdetr_tpu_torch.ops.voxelize import VoxelGrid
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def t(a):
    return torch.from_numpy(np.array(a))


def _isolated_grid():
    """Voxels with no neighbour but themselves (tests/test_map_kernel.py)."""
    V = 256
    pts = (np.arange(V)[:, None] * np.array([1.0, 0.7, 0.3]))[None]
    return jax_voxelize(jnp.asarray(pts, jnp.float32),
                        jnp.asarray(pts, jnp.float32),
                        jnp.ones((1, V), bool), voxel_size=0.05, capacity=V)


# one batch of every layout (so the interpret-mode TPU kernel compiles
# once per query shape): the clustered sites twice (B = 2 of one scene),
# the comb wall, the isolated sites
LAYOUTS = ("clustered-0", "clustered-1", "comb-wall", "isolated")
CAPACITY = 1152  # the comb wall's


def _pad(grid, capacity):
    """grid's per-row arrays padded to `capacity` empty slots."""
    n = capacity - grid.keys.shape[1]
    return (jnp.pad(grid.keys, ((0, 0), (0, n)), constant_values=2 ** 31 - 1),
            jnp.pad(grid.coords, ((0, 0), (0, n), (0, 0))),
            jnp.pad(grid.valid, ((0, 0), (0, n))))


@pytest.fixture(scope="module")
def maps():
    """Per stride, (query validity, port map, _zrun_neighbors map,
    stencil_map map) of the batch of layouts."""
    grids = [_grid(np.random.RandomState(11), V=512, B=2), _comb_wall_grid(),
             _isolated_grid()]
    keys, coords, valid = (jnp.concatenate(a) for a in
                           zip(*(_pad(g, CAPACITY) for g in grids)))
    extent = grids[0].extent
    assert all(g.extent == extent for g in grids)
    table = grids[0].replace(keys=keys, coords=coords, valid=valid,
                             features=jnp.zeros(keys.shape + (1,)),
                             origin=jnp.zeros((len(LAYOUTS), 3), jnp.int32))
    out = {}
    # each JAX map one compiled program (op by op, the interpret-mode
    # kernel ran each of its operations apart)
    zrun_map = jax.jit(jax.vmap(lambda k, c, v: jsc._zrun_neighbors(
        k, c, v, extent, 1)))
    stencil_map = jax.jit(lambda k, c, v: jmk.stencil_map(
        k, c, v, extent, interpret=True))
    for stride in (1, 2):
        if stride == 1:
            q, qv = coords, valid
        else:
            down = jax.jit(lambda g: jax_downsample(
                g, CAPACITY // 256 * 128))(table)
            q, qv = down.coords * 2, down.valid
        zrun = zrun_map(keys, q, qv)
        stencil, n_unpatched = stencil_map(keys, q, qv)
        assert int(n_unpatched) == 0  # the TPU kernel's map is exact here
        got = kernel_map(t(keys), t(q), t(qv), extent)
        out[stride] = (np.asarray(qv), got, np.asarray(zrun),
                       np.asarray(stencil))
    return out


@pytest.mark.parametrize("stride", [1, 2], ids=["submanifold", "stride-2"])
@pytest.mark.parametrize("row", range(len(LAYOUTS)), ids=LAYOUTS)
def test_map_equals_jax_zrun_and_stencil_map(maps, row, stride):
    valid, got, zrun, stencil = maps[stride]
    assert got.dtype == torch.int32 and got.shape == zrun.shape
    assert valid[row].sum() > 50  # the layout has sites at this level
    np.testing.assert_array_equal(got[row].numpy(), zrun[row])
    np.testing.assert_array_equal(got[row].numpy(), stencil[row])


def test_isolated_sites_hit_only_themselves(maps):
    valid, got, _, _ = maps[1]
    row = LAYOUTS.index("isolated")
    nbr, v = got[row].numpy(), valid[row]
    np.testing.assert_array_equal(nbr[13][v], np.arange(CAPACITY)[v])
    assert (np.delete(nbr, 13, axis=0)[:, v] == CAPACITY).all()


def test_attach_kernel_map_equals_jax():
    """The grid-level entry: the port's `attach_kernel_map` on the same
    sites as JAX's (which builds its map with `_zrun_neighbors` off the
    TPU); `replace` keeps the map."""
    jg = _grid(np.random.RandomState(3), V=512, B=2)
    ref = jsc.attach_kernel_map(jg).nbr_idx
    tg = VoxelGrid(coords=t(jg.coords), keys=t(jg.keys),
                   features=t(jg.features), valid=t(jg.valid),
                   origin=t(jg.origin), stride=jg.stride,
                   extent=tuple(jg.extent), voxel_size=jg.voxel_size)
    assert tg.nbr_idx is None
    got = tsc.attach_kernel_map(tg)
    np.testing.assert_array_equal(got.nbr_idx.numpy(), np.asarray(ref))
    assert got.replace(features=got.features * 2).nbr_idx is got.nbr_idx


def test_map_at_lattice_borders_and_invalid_rows():
    """Sites on every face of a small lattice: a neighbour one past a face
    must be a miss, not the key of the next z row or y slice, and an
    invalid query row misses everywhere (the table's empty slots hold
    KEY_SENTINEL)."""
    ext = (4, 3, 5)
    cells = np.array([(x, y, z) for x in range(4) for y in range(3)
                      for z in range(5)], np.int32)
    keep = np.random.RandomState(5).rand(len(cells)) < 0.7
    c = cells[keep]
    V_in = 64
    keys = np.full((1, V_in), 2 ** 31 - 1, np.int32)
    keys[0, :len(c)] = (c[:, 0] * ext[1] + c[:, 1]) * ext[2] + c[:, 2]
    q = np.zeros((1, V_in, 3), np.int32)
    q[0, :len(c)] = c
    qv = np.zeros((1, V_in), bool)
    qv[0, :len(c)] = True
    qv[0, 3] = False  # a valid site queried as an invalid row
    ref = jax.vmap(lambda k, cc, v: jsc._zrun_neighbors(k, cc, v, ext, 1))(
        jnp.asarray(keys), jnp.asarray(q), jnp.asarray(qv))
    got = neighbour_map(t(keys), t(q), t(qv), ext)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[0, :, 3] == V_in).all()
    assert (got[0, :, len(c):] == V_in).all()


def test_kernel_map_takes_plain_path_on_cpu():
    jg = _grid(np.random.RandomState(4), V=256)
    args = (t(jg.keys), t(jg.coords), t(jg.valid), jg.extent)
    before = kernel_map.launches
    np.testing.assert_array_equal(kernel_map(*args).numpy(),
                                  neighbour_map(*args).numpy())
    assert kernel_map.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("stride", [1, 2], ids=["submanifold", "stride-2"])
def test_dw_rulebook_holds_the_zrun_maps_hits_in_row_order(maps, stride,
                                                           splits):
    """The plain rulebook of kernels D and I built from JAX's
    `_zrun_neighbors` map of the batch of layouts: per (offset, row
    split), exactly the map's hits as (b * V_in + row, b * V + v) pairs,
    ascending in the query row, -1 past the count; and dW summed over the
    pairs equals the plain dW over the whole map."""
    _, _, zrun, _ = maps[stride]
    B, _, V = zrun.shape
    per = -(-B * V // (splits * 32)) * 32
    src, row, count = dw_rulebook(t(zrun), CAPACITY, splits, per)
    assert src.shape == row.shape == (27, splits, per)
    rng = np.random.RandomState(7)
    feats = torch.from_numpy(rng.randn(B, CAPACITY, 5).astype(np.float32))
    dout = torch.from_numpy(rng.randn(B, V, 3).astype(np.float32))
    dw = torch.zeros(27, 5, 3, dtype=torch.float64)
    for k in range(27):
        b, v = np.nonzero(zrun[:, k] < CAPACITY)  # ascending in b * V + v
        r, i = b * V + v, b * CAPACITY + zrun[:, k][b, v]
        for sp in range(splits):
            sel = r // per == sp
            n = int(count[k, sp])
            assert n == sel.sum()
            np.testing.assert_array_equal(row[k, sp, :n].numpy(), r[sel])
            np.testing.assert_array_equal(src[k, sp, :n].numpy(), i[sel])
            assert (row[k, sp, n:] == -1).all()
            assert (src[k, sp, n:] == -1).all()
            dw[k] += (feats.reshape(-1, 5)[src[k, sp, :n].long()].double().t()
                      @ dout.reshape(-1, 3)[row[k, sp, :n].long()].double())
    ref = mapped_conv_dw_plain(feats, t(zrun), dout)
    np.testing.assert_allclose(dw.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


def test_dw_rulebook_of_isolated_sites_has_empty_offsets(maps):
    """The isolated sites hit only themselves: the rulebook's 26 other
    offsets are empty lists in every split, the centre offset lists every
    valid row, and a split past the rows is empty too."""
    valid, _, zrun, _ = maps[1]
    row = LAYOUTS.index("isolated")
    src, rows, count = dw_rulebook(t(zrun[row:row + 1]), CAPACITY, 3, 512)
    assert (np.delete(count.numpy(), 13, axis=0) == 0).all()
    assert (np.delete(src.numpy(), 13, axis=0) == -1).all()
    assert int(count[13].sum()) == int(valid[row].sum())
    got = rows[13][rows[13] >= 0].numpy()
    np.testing.assert_array_equal(got, np.nonzero(valid[row])[0])
    np.testing.assert_array_equal(src[13][src[13] >= 0].numpy(), got)
    src, _, count = dw_rulebook(t(zrun[row:row + 1]), CAPACITY, 4, 512)
    assert int(count[:, 3].sum()) == 0 and (src[:, 3] == -1).all()


@pytest.mark.parametrize("rows,C,Co", [
    (65536, 3, 64), (32768, 64, 64), (16384, 64, 128), (4096, 512, 512),
    (2 * 4003, 40, 8), (1, 3, 16)])
def test_dw_row_splits_cover_the_rows_in_32_row_stages(rows, C, Co):
    """The launch plan of kernels D and I at the published convs' shapes
    and off them: each split a multiple of the 32-row stage, the splits
    cover every row and none is empty; the dense form (all 27 offsets in
    a block) exactly for the stem's 3 channels."""
    splits, per = dw_row_splits(rows, C, Co)
    assert per % 32 == 0
    assert splits * per >= rows > (splits - 1) * per
    assert dw_dense(C) == (C == 3)


@pytest.mark.parametrize("rows,C,Co", [
    (65536, 8, 64), (32768, 64, 64), (16384, 64, 128), (4096, 512, 512),
    (8192, 256, 256), (2 * 4003, 40, 8), (1, 8, 16)])
def test_dw_row_splits_of_the_bf16_form(rows, C, Co):
    """The bf16 form's launch plan (its own, since the split sets the
    order of the sums): splits a multiple of the 32-row rulebook rounds
    that cover every row, none empty; the dense form exactly at 8
    channels (the stem's 3 padded); its blocks a split (`dw_tiles`) the
    dense (216, Co) matrix's 64-column tiles, else 27 offsets' tiles of
    128 x 128 where C and Co both exceed 64, 64 x 64 otherwise; and at
    least the plan's rounds of the blocks 132 SMs hold (two 64 x 64
    blocks an SM, one larger) where the rows allow."""
    splits, per = dw_row_splits(rows, C, Co, bf16=True)
    assert per % 32 == 0
    assert splits * per >= rows > (splits - 1) * per
    assert dw_dense(C, bf16=True) == (C == 8)
    t = 128 if C > 64 and Co > 64 else 64
    tiles = -(-Co // 64) if C == 8 else 27 * -(-C // t) * -(-Co // t)
    assert dw_tiles(C, Co, bf16=True) == tiles
    per_sm = 2 if t == 64 and C != 8 else 1
    assert dw_blocks_per_sm(C, Co, bf16=True) == per_sm
    waves, min_rows = DW_PLAN[True]
    assert splits * tiles >= min(waves * per_sm * 132,
                                 -(-rows // min_rows) * tiles)
