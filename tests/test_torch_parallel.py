"""Data parallelism of the port on the CPU: ranks in spawned processes,
gloo, a `file://` rendezvous, each group under a time limit (a rank that
hangs or raises fails the test).

- The port's 2-rank train step (one synthetic scene per rank: different
  GT and voxel counts, so that sync-BN's count weighting and the
  criterion's mean GT count both show) against the JAX package's
  2-device `shard_map` step on the same scenes and numpy-seeded weights:
  the model and criterion with `axis_name="data"`, `value_and_grad` per
  device, then the grads, loss and loss dict pmean'd, as
  `vdetr_tpu/train/engine.py:177-206`, and optax's update. Compared at
  `test_torch_train_step.py`'s tolerances: the loss and every term,
  every gradient after the clip, every parameter after AdamW, every
  running statistic; and both ranks' gradients and parameters bit for
  bit.
- `mink_syncbn=False` against JAX's model with `axis_name=None`, and the
  two runs differ (the test sees sync-BN).
- The synced 2-rank step on the scenes of seeds 5 and 7 against JAX's
  single-device step on both scenes at once, in both row orders: at seed
  7 JAX's own step moves its deepest sparse convs' gradients by ~25x the
  tolerance when the rows swap (a point of the loss where f32 rounding
  picks the one-sided derivative), which is why JAX's shard_map step
  departs from it there; the ranks' step must be one of the two.
- `evaluate` at 2 ranks over 3 scenes at global batch 2 with `pad_last`
  against one process at batch 2: the calculator of rank 0 is handed
  the same outputs and GT and gives the same metrics; the padded row is
  not scored.
- The CLI: two ranks of `main(argv, device="cpu")` under torchrun's
  variables: an epoch with a checkpoint directory, then a resumed
  second; rank 0 alone writes, both ranks return the same metrics, and
  the checkpoint loads at world size 1 with every tensor equal to the
  ranks' model.
"""

import datetime
import functools
import multiprocessing
import os
import socket
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from test_torch_model import _random_tree, flax_shapes
from test_torch_train_step import (GRAD_FLOOR, GRAD_TOL, LOSS_RTOL,
                                   STATS_ATOL, STATS_RTOL, TINY, _port_tree)
from torch_dp_ranks import cli_rank, eval_rank, evaluate_scenes
from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.data import ScannetDatasetConfig as JaxScannetConfig
from vdetr_tpu.models import build_model as build_jax_model
from vdetr_tpu.parallel import make_mesh
from vdetr_tpu.train.criterion import SetCriterion as JaxCriterion
from vdetr_tpu.train.optimizer import build_optimizer as jax_optimizer
from vdetr_tpu.train.schedule import make_lr_schedule
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.convert import load_jax_params
from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
from vdetr_tpu_torch.data.synthetic import SyntheticDetectionDataset, collate
from vdetr_tpu_torch.eval.ap_calculator import AP_TARGET_KEYS
from vdetr_tpu_torch.models.vdetr import build_model
from vdetr_tpu_torch.tools import run_ranks
from vdetr_tpu_torch.tools.dp_step import train_rank
from vdetr_tpu_torch.train import checkpoint as ckpt_io
from vdetr_tpu_torch.train.engine import INPUT_KEYS, Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 2
# a group's collectives wait at most this long; the whole group at most
# RANKS_TIMEOUT s (spawning, importing and building included)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
RANKS_TIMEOUT = 300


def _spec(tmp, name, **kw):
    return dict(world=WORLD, init_method=f"file://{tmp}/{name}",
                backend="gloo", device="cpu", threads=1,
                timeout=COLLECTIVE_TIMEOUT, **kw)


def jax_dp_step(jcfg, params, stats, batch, synced):
    """The JAX package's data-parallel step on a 2-device mesh, each
    device one row of `batch`: the loss, the loss dict, the gradients
    (pmean'd, before the clip), the parameters after the update, and the
    batch statistics (device 0's)."""
    mesh = make_mesh(("data",), (WORLD,), devices=jax.devices()[:WORLD])
    model = build_jax_model(jcfg, JaxScannetConfig(),
                            axis_name="data" if synced else None)
    crit = JaxCriterion(jcfg, JaxScannetConfig(), axis_name="data")
    tx = jax_optimizer(jcfg, make_lr_schedule(jcfg, 1))

    def per_device(params, stats, opt_state, batch):
        def loss_fn(p):
            out, mutated = model.apply(
                {"params": p, "batch_stats": stats},
                {k: batch[k] for k in INPUT_KEYS}, train=True,
                mutable=["batch_stats"])
            loss, parts = crit(out, batch)
            return loss, (parts, mutated["batch_stats"])

        (loss, (parts, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        grads = jax.lax.pmean(grads, "data")
        loss = jax.lax.pmean(loss, "data")
        parts = jax.tree.map(lambda x: jax.lax.pmean(x, "data"), parts)
        updates, _ = tx.update(grads, opt_state, params)
        return (loss, parts, grads, optax.apply_updates(params, updates),
                new_stats)

    step = jax.jit(shard_map(
        per_device, mesh=mesh, in_specs=(P(), P(), P(), P("data")),
        out_specs=P(), check_vma=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    return step(params, stats, tx.init(params), batch)


def jax_single_steps(jcfg, params, stats, batches):
    """The JAX package's single-device step (`jax.value_and_grad` of the
    model and criterion on the whole batch, then optax's update) on each
    of `batches`, one compile: per batch (loss, loss dict, gradients
    before the clip, parameters after the update, batch statistics)."""
    model = build_jax_model(jcfg, JaxScannetConfig())
    crit = JaxCriterion(jcfg, JaxScannetConfig())
    tx = jax_optimizer(jcfg, make_lr_schedule(jcfg, 1))

    def step(params, stats, opt_state, batch):
        def loss_fn(p):
            out, mutated = model.apply(
                {"params": p, "batch_stats": stats},
                {k: batch[k] for k in INPUT_KEYS}, train=True,
                mutable=["batch_stats"])
            loss, parts = crit(out, batch)
            return loss, (parts, mutated["batch_stats"])

        (loss, (parts, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return (loss, parts, grads, optax.apply_updates(params, updates),
                new_stats)

    step = jax.jit(step)
    return [jax.tree.map(np.asarray, step(
        params, stats, tx.init(params),
        {k: jnp.asarray(v) for k, v in b.items()})) for b in batches]


def cli_runs(ckpt):
    """Two ranks of the CLI for an epoch with checkpoints in `ckpt`, then
    for a second resumed from them: each run's ranks' results."""
    runs = []
    for epochs in (1, 2):
        argv = CLI_TINY + ["--max_epoch", str(epochs), "--checkpoint_dir",
                           ckpt]
        runs.append(run_ranks(cli_rank, WORLD, dict(
            world=WORLD, port=_free_port(), argv=argv), RANKS_TIMEOUT))
    return runs


def jax_dp_step_np(*args):
    """`jax_dp_step` with numpy leaves (what a worker process returns)."""
    return jax.tree.map(np.asarray, jax_dp_step(*args))


def swapped(batch):
    """The batch with its two rows in the other order."""
    return {k: np.ascontiguousarray(v[::-1]) for k, v in batch.items()}


def scenes(seed):
    data = SyntheticDetectionDataset(ScannetDatasetConfig(), num_points=1024,
                                     num_scenes=2, max_objects=4, seed=seed)
    return collate([data[i] for i in range(WORLD)])


def one_process_grads(state, batch):
    """The port's gradients (after the clip) of one process's step on
    both scenes of `batch`, from the state_dict at `state`."""
    cfg = VDETRConfig(**TINY)
    model = build_model(cfg, ScannetDatasetConfig(), device="cpu")
    model.load_state_dict(torch.load(state, weights_only=True))
    Trainer(cfg, model, ScannetDatasetConfig(), 1,
            device="cpu").train_step(batch, torch.Generator())
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run the tests compare, started at once: the port's groups,
    each in a thread that waits on its spawned ranks, JAX's synced step in
    a thread, its unsynced and single-device steps in spawned processes
    (tracing holds the interpreter lock), so that the file takes about as
    long as the longest of them. The steps against JAX share two scenes
    (GT counts 4 and 3, voxel counts 994 and 985) and the numpy-seeded
    weights, which reach the ranks as the port's state_dict on disk.
    {name: future}."""
    tmp = tmp_path_factory.mktemp("dp")
    batch = scenes(10)
    jcfg = JaxConfig(**TINY)
    shapes = flax_shapes(VDETRConfig(**TINY), ScannetDatasetConfig())
    rng = np.random.RandomState(5)
    params = _random_tree(shapes["params"], rng)
    stats = _random_tree(shapes["batch_stats"], rng, stats=True)
    port = build_model(VDETRConfig(**TINY), ScannetDatasetConfig(),
                       device="cpu")
    load_jax_params(port, params, stats, VDETRConfig(**TINY))
    state = str(tmp / "state.pt")
    torch.save(port.state_dict(), state)
    eval_data = SyntheticDetectionDataset(
        ScannetDatasetConfig(), num_points=1024, num_scenes=3,
        max_objects=4, seed=6)
    jobs = {"batch": batch, "ckpt": str(tmp / "ckpt")}
    spawn = multiprocessing.get_context("spawn")
    with ThreadPoolExecutor(max_workers=8) as pool, \
            ProcessPoolExecutor(max_workers=2, mp_context=spawn) as procs:
        jobs["jax", False] = procs.submit(jax_dp_step_np, jcfg, params,
                                          stats, batch, False)
        jobs["jax single"] = procs.submit(
            jax_single_steps, jcfg, params, stats,
            [b for seed in (5, 7) for b in (scenes(seed),
                                            swapped(scenes(seed)))])
        for synced in (True, False):
            jobs["port", synced] = pool.submit(
                run_ranks, train_rank, WORLD, _spec(
                    tmp, f"rdzv_{synced}",
                    cfg=VDETRConfig(**TINY, mink_syncbn=synced),
                    state=state, batches=[batch]), RANKS_TIMEOUT)
        for seed in (5, 7):
            jobs["port", seed] = pool.submit(
                run_ranks, train_rank, WORLD, _spec(
                    tmp, f"rdzv_{seed}", cfg=VDETRConfig(**TINY),
                    state=state, batches=[scenes(seed)]), RANKS_TIMEOUT)
        jobs["one process", 5] = pool.submit(one_process_grads, state,
                                             scenes(5))
        jobs["eval"] = pool.submit(run_ranks, eval_rank, WORLD, dict(
            world=WORLD, init_method=f"file://{tmp}/rdzv_eval",
            timeout=COLLECTIVE_TIMEOUT, cfg=VDETRConfig(**TINY),
            data=eval_data, global_batch=2), RANKS_TIMEOUT)
        jobs["eval one process"] = pool.submit(
            evaluate_scenes, VDETRConfig(**TINY), eval_data, 2)
        jobs["cli"] = pool.submit(cli_runs, jobs["ckpt"])
        jobs["jax", True] = pool.submit(jax_dp_step, jcfg, params, stats,
                                        batch, True)
        for f in [f for f in jobs.values() if hasattr(f, "exception")]:
            f.exception()  # wait, with the worker process still up
    return jobs


def both_steps(runs, synced):
    """(JAX's step, each rank's step) in the form of the flax trees."""
    return jax_and_ranks(runs["jax", synced].result(),
                         runs["port", synced].result(),
                         VDETRConfig(**TINY, mink_syncbn=synced))


def jax_and_ranks(jax_step, ranks, cfg):
    """A JAX step's (loss, loss dict, grads, params, stats) and each
    rank's step, both as flax trees, JAX's gradients clipped as the
    port clips."""
    loss, parts, grads, new_params, new_stats = jax_step
    flat = lambda t: _port_tree(t, cfg)  # noqa: E731
    grads = flat_tree(grads)
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                        for g in grads.values()))
    clip = min(1.0, cfg.clip_gradient / gnorm)
    ref = dict(loss=float(loss), parts=jax.tree.map(float, parts),
               grads={k: v * clip for k, v in grads.items()},
               params=flat_tree(new_params), stats=flat_tree(new_stats))
    got = []
    for r in ranks:
        p_loss, p_parts = r["steps"][0][:2]
        params_p, stats_p = flat({**r["params"], **r["buffers"]})
        got.append(dict(loss=p_loss, parts=p_parts,
                        grads=flat(r["grads"])[0], params=params_p,
                        stats=stats_p, raw=r))
    return ref, got


def flat_tree(tree):
    from vdetr_tpu.train.torch_import import _flatten

    return _flatten(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def synced(runs):
    return both_steps(runs, True)


@pytest.fixture(scope="module")
def unsynced(runs):
    return both_steps(runs, False)


@functools.lru_cache(maxsize=None)
def first_lr():
    """The JAX schedule's learning rate at step 0 (jitted: op by op, each
    primitive compiled apart)."""
    return float(jax.jit(make_lr_schedule(JaxConfig(**TINY), 1))(0))


def check_against_jax(ref, got):
    lr = first_lr()
    assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    assert set(got["parts"]) == set(ref["parts"])
    for k, v in ref["parts"].items():
        assert got["parts"][k] == pytest.approx(v, rel=LOSS_RTOL,
                                                abs=1e-6), k
    assert set(got["grads"]) == set(ref["grads"])
    top = max(np.abs(g).max() for g in ref["grads"].values())
    for k, want in ref["grads"].items():
        d = max(GRAD_TOL * np.abs(want).max(), GRAD_FLOOR * top)
        np.testing.assert_allclose(got["grads"][k], want, rtol=0, atol=d,
                                   err_msg=str(k))
        # AdamW's first step: see test_torch_train_step's
        # test_adamw_step_matches_optax
        bound = lr * np.minimum(2.0, d / (np.abs(want) + 1e-8)) + 1e-6
        err = np.abs(got["params"][k] - ref["params"][k])
        assert (err <= bound).all(), (k, float((err - bound).max()))
    assert set(got["stats"]) == set(ref["stats"])
    for k, want in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], want, rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=str(k))


def test_scenes_differ_in_gt_and_voxel_counts(runs):
    batch = runs["batch"]
    gt = batch["gt_box_present"].sum(1)
    assert gt[0] != gt[1]
    voxels = [len(np.unique(np.floor(pc[:, :3] / TINY["voxel_size"]),
                            axis=0)) for pc in batch["point_clouds"]]
    assert voxels[0] != voxels[1]


def test_synced_step_matches_jax_shard_map(synced):
    ref, got = synced
    check_against_jax(ref, got[0])


def test_unsynced_step_matches_jax_without_axis_name(unsynced):
    """mink_syncbn=False: each rank's batch norms take their own
    statistics (JAX: the model's axis_name None); the running statistics
    compared are rank 0's (JAX's replicated output: device 0's)."""
    ref, got = unsynced
    check_against_jax(ref, got[0])


@pytest.mark.parametrize("which", ["synced", "unsynced"])
def test_ranks_agree_bit_for_bit(which, request):
    _, got = request.getfixturevalue(which)
    a, b = (g["raw"] for g in got)
    assert a["steps"][0][0] == b["steps"][0][0]  # the mean loss
    for key in ("grads", "params"):
        for k, v in a[key].items():
            assert torch.equal(v, b[key][k]), (key, k)
    if which == "synced":  # the same statistics on every rank
        for k, v in a["buffers"].items():
            assert torch.equal(v, b["buffers"][k]), k


def test_synced_ranks_equal_one_process_on_both_scenes(runs):
    """The 2-rank synced step is the step of one process on both scenes,
    up to the order of f32 sums: the batch norms' statistics are those of
    the two scenes together (weighted by their voxel counts), and the
    mean of the ranks' losses, each normalized by the ranks' mean GT
    count, is the one process's loss normalized by the total count (both
    scenes have GT). At GT counts 4 and 3 (seed 5), where JAX's own
    shard_map step departs from its single-device step of the same
    function, up to 25x the tolerance in the deepest sparse convs'
    gradients (and at seed 7; not at seeds 4, 10 and 13); the ranks are
    held to JAX's single-device step at seeds 5 and 7 below."""
    cfg = VDETRConfig(**TINY)
    ranks = runs["port", 5].result()
    got = _port_tree(ranks[0]["grads"], cfg)[0]
    want = _port_tree(runs["one process", 5].result(), cfg)[0]
    top = max(np.abs(g).max() for g in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0,
            atol=max(GRAD_TOL * np.abs(w).max(), GRAD_FLOOR * top),
            err_msg=str(k))


def jax_single(runs, seed, order):
    """JAX's single-device step on the scenes of `seed`, their rows in the
    given order (0 as drawn, 1 swapped)."""
    return runs["jax single"].result()[2 * (5, 7).index(seed) + order]


def gradient_change(a, b):
    """The largest difference of two JAX steps' gradients, in units of
    the tolerance the steps are compared at."""
    a, b = flat_tree(a[2]), flat_tree(b[2])
    top = max(np.abs(g).max() for g in a.values())
    return max(float(np.abs(a[k] - b[k]).max())
               / max(GRAD_TOL * np.abs(a[k]).max(), GRAD_FLOOR * top)
               for k in a)


def test_jax_single_device_step_at_seed_7_depends_on_the_row_order(runs):
    """The quirk behind JAX's shard_map step departing from its
    single-device step at seed 7: its single-device step alone moves its
    deepest sparse convs' gradients by ~25x the tolerance when the two
    scenes swap rows (the same function, other f32 sums). The step sits
    on a point of the loss where f32 rounding picks the one-sided
    derivative. At seed 5 the order changes nothing."""
    assert gradient_change(jax_single(runs, 7, 0), jax_single(runs, 7, 1)) \
        > 10
    assert gradient_change(jax_single(runs, 5, 0), jax_single(runs, 5, 1)) \
        < 1


@pytest.mark.parametrize("seed", [5, 7])
def test_synced_ranks_match_jax_single_device_step(seed, runs):
    """The 2-rank synced step on the two scenes of seeds 5 and 7, held to
    JAX's single-device step on both scenes at once: the step that
    sync-BN and the mean GT count make the ranks' step equal to. JAX's
    step is taken in both row orders: at seed 5 they agree, at seed 7
    they are two one-sided derivatives ~25x the tolerance apart (the test
    above), and the ranks' step must be one of them."""
    cfg = VDETRConfig(**TINY)
    ranks = runs["port", seed].result()
    errors = []
    for order in (0, 1):
        ref, got = jax_and_ranks(jax_single(runs, seed, order), ranks, cfg)
        try:
            check_against_jax(ref, got[0])
            return
        except AssertionError as e:
            errors.append(e)
    raise errors[0]


def test_sync_bn_changes_the_step(synced, unsynced):
    """The control: what the synced run's statistics and gradients would
    be without the all-reduce is what the unsynced run computes, and it
    differs."""
    (_, s), (_, u) = synced, unsynced
    assert s[0]["loss"] != u[0]["loss"]
    diff = max(float(np.abs(s[0]["stats"][k] - u[0]["stats"][k]).max())
               for k in s[0]["stats"])
    assert diff > 1e-3
    gdiff = max(float(np.abs(s[0]["grads"][k] - u[0]["grads"][k]).max())
                for k in s[0]["grads"])
    assert gdiff > 1e-6


# ---- evaluate at 2 ranks ----------------------------------------------

def test_evaluate_gathers_the_global_batch(runs):
    """Rank 0's calculator is handed every rank's outputs and GT fields,
    in rank order, for each global batch of 2 of 3 scenes: what one
    process at batch 2 hands it; the other rank's is handed nothing."""
    ranks, one = runs["eval"].result(), runs["eval one process"].result()
    zero, other = ranks
    assert one["scan_cnt"] == zero["scan_cnt"] == 3  # the pad not scored
    assert other["scan_cnt"] == 0 and not other["handed"]
    assert len(zero["handed"]) == len(one["handed"]) == 2
    for (out, tgt), (out1, tgt1) in zip(zero["handed"], one["handed"]):
        assert set(out) == set(out1)
        assert set(tgt) == set(AP_TARGET_KEYS)
        for k in AP_TARGET_KEYS:
            assert torch.equal(tgt[k], tgt1[k]), k
        for k, v in out1.items():
            if v.dtype == torch.bool:
                assert torch.equal(out[k], v), k
            else:
                torch.testing.assert_close(out[k], v, rtol=0, atol=1e-5,
                                           msg=k)
    assert zero["handed"][1][1]["sample_valid"].tolist() == [True, False]
    for t, m in one["metrics"].items():
        assert set(zero["metrics"][t]) == set(m)
        for k, v in m.items():
            np.testing.assert_allclose(zero["metrics"][t][k], v,
                                       rtol=1e-6, err_msg=f"{t} {k}")


# ---- the CLI at 2 ranks -----------------------------------------------

CLI_TINY = [
    "--dataset_name", "synthetic",
    "--voxel_capacity", "1024", "--min_stage_capacity", "128",
    "--preenc_npoints", "64", "--nqueries", "32",
    "--dec_nlayers", "2", "--dec_dim", "32", "--dec_ffn_dim", "32",
    "--rpe_dim", "8", "--inplanes", "8", "--enc_dim", "32",
    "--fps_impl", "jax", "--num_points", "512", "--repeat_num", "2",
    "--batchsize_per_gpu", "4", "--dataset_num_workers", "0",
    "--eval_every_epoch", "10",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_two_ranks_train_checkpoint_resume(runs):
    cli, ckpt = runs["cli"].result(), runs["ckpt"]
    for zero, other in cli:
        assert zero["overall"] == other["overall"]
        assert np.isfinite(zero["overall"][0.25]["mAP"])
        assert other["written"] == []
        assert any(p.endswith("state.pt.tmp") for p in zero["written"])
        assert any(p.endswith("header.json.tmp") for p in zero["written"])
        assert any(p.endswith("final_eval.txt") for p in zero["written"])
    assert ckpt_io.read_header(os.path.join(ckpt, ckpt_io.LATEST))[
        "epoch"] == 1  # the second run resumed at epoch 1

    # the last checkpoint at world size 1: every tensor as the ranks held
    cfg, _ = ckpt_io.load_config(os.path.join(ckpt, ckpt_io.LATEST))
    ds = ScannetDatasetConfig()
    trainer = Trainer(cfg, build_model(cfg, ds, device="cpu"), ds, 1,
                      device="cpu")
    ckpt_io.load_checkpoint(os.path.join(ckpt, ckpt_io.LATEST), trainer)
    assert trainer.step == 2 * 64 // 8  # two epochs of global batch 8
    held = cli[1][1]["saved"][ckpt_io.LATEST]  # rank 1's model
    sd = trainer.model.state_dict()
    assert set(sd) == set(held)
    for k, v in held.items():
        assert torch.equal(sd[k], v), k


# ---- the loader's rows per rank -----------------------------------------

@pytest.mark.parametrize("world,batch,pad_last", [(2, 2, True), (3, 3, True),
                                                  (2, 4, False)])
def test_loader_ranks_hold_the_global_batch_rows(world, batch, pad_last):
    """Every rank draws the global plan and fetches its own rows; the
    ranks' batches, concatenated in rank order, are the global batch
    (`sample_valid` included: the pad rows of the global batch)."""
    from vdetr_tpu_torch.data.loader import prefetch_loader

    data = SyntheticDetectionDataset(ScannetDatasetConfig(), num_points=512,
                                     num_scenes=7, max_objects=4, seed=1)
    kw = dict(shuffle=True, seed=3, pad_last=pad_last)
    whole = list(prefetch_loader(data, batch, **kw))
    ranks = [list(prefetch_loader(data, batch, rank=r, world=world, **kw))
             for r in range(world)]
    assert all(len(r) == len(whole) for r in ranks)
    for i, want in enumerate(whole):
        for k, v in want.items():
            got = np.concatenate([r[i][k] for r in ranks])
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_loader_refuses_a_short_last_batch_across_ranks():
    from vdetr_tpu_torch.data.loader import prefetch_loader

    with pytest.raises(ValueError):
        next(prefetch_loader(list(range(5)), 2, drop_last=False, rank=0,
                             world=2))
