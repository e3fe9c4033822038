"""Key sharding of the whole model on the CPU: the port's seq mode at
mesh ("data", "seq") = (2, 2), four ranks in spawned processes over gloo
(`tests/torch_seq_ranks.py:seq_model_rank`, started once for the module),
against the JAX package's seq mode under `shard_map` on 4 of the 8 CPU
devices, on the same numpy-seeded weights (`convert.py`) and scenes.

- The seq decoder on each rank's seeds against JAX's seq decoder, at
  `tests/test_seq_model.py`'s atol 2e-4 / rtol 1e-3.
- One whole train step (shard-local encoder, sync-BN over every rank,
  seeds sharded, the global top-k, the sharded RPE attention) against
  JAX's `Trainer` step on the same mesh: the loss and every term, the
  train-mode outputs, every gradient after the clip, every parameter
  after AdamW and the running statistics, at `test_torch_train_step.py`'s
  tolerances. JAX's step is its `Trainer.train_step`, its optimizer
  chained after a transformation that keeps the gradients it is handed
  in its state and its criterion adding the train-mode outputs (each data
  row's in its own slot) to the loss dict. The backbone is cut to depth
  18 (BasicBlock (2, 2, 2, 2)) to keep JAX's compile short. JAX's own
  gradients come out S = 2 times the
  exact ones: its psum transposes to a psum, so the seq-mean of the loss
  does not split the cotangent, and the psum over "seq" then counts every
  replica (`test_jax_seq_step_gradients_are_s_times_exact` shows it on a
  scalar); the port takes the exact mean over the rows, and is held to
  JAX's divided by S, which AdamW after the clip turns into the same
  update. Every rank's parameters are bit-equal after the step.
- The eval step (`test_only`: empty-box removal and the device NMS)
  against JAX's `Trainer.eval_step`: every rank returns seq rank 0's
  outputs, and JAX's empty-box counts read seq rank 0's point block
  alone, not the scene (a quirk of the reference the port follows).
- A config with a "seq" axis never runs dense: the model without a seq
  group raises, and so do a trainer and the CLI (`main(...,
  mesh_axis_names, mesh_shape)`) whose world is not the mesh's.
"""

import datetime
import multiprocessing
import threading
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from test_torch_model import _random_tree, flax_shapes
from test_torch_parallel import check_against_jax, flat_tree
from test_torch_train_step import TINY
from torch_seq_ranks import seq_model_rank
from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.data import ScannetDatasetConfig as JaxScannetConfig
from vdetr_tpu.models import build_model as build_jax_model
from vdetr_tpu.models.transformer import TransformerDecoder
from vdetr_tpu.parallel import make_mesh
from vdetr_tpu.train.engine import TrainState
from vdetr_tpu.train.engine import Trainer as JaxTrainer
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.convert import jax_trees, load_jax_params
from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
from vdetr_tpu_torch.data.loader import seq_block
from vdetr_tpu_torch.data.synthetic import SyntheticDetectionDataset, collate
from vdetr_tpu_torch.main import main
from vdetr_tpu_torch.models.vdetr import build_model
from vdetr_tpu_torch.tools import run_ranks
from vdetr_tpu_torch.train.engine import INPUT_KEYS, Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

D, S = 2, 2
MESH = dict(mesh_axis_names=("data", "seq"), mesh_shape=(D, S))
SEQ_TINY = dict(TINY, depth=18)
ATOL, RTOL = 2e-4, 1e-3
OUTPUT_KEYS = ("sem_cls_logits", "center_unnormalized", "size_unnormalized",
               "angle_continuous", "objectness_prob")
# the eval step's empty-box threshold: between a box's point count over
# seq rank 0's block and over the whole scene for some boxes of these
# scenes and weights, so that which of the two JAX counts shows
EMPTY_PT_THRE = 40
DEC_SEEDS = 64


def scenes():
    data = SyntheticDetectionDataset(ScannetDatasetConfig(), num_points=1024,
                                     num_scenes=D, max_objects=4, seed=11)
    return collate([data[i] for i in range(D)])


def decoder_inputs():
    rng = np.random.RandomState(2)
    n, C = DEC_SEEDS, TINY["dec_dim"]
    xyz = (rng.rand(D, n, 3) * 4).astype(np.float32)
    dmin, dmax = xyz.min(1), xyz.max(1)
    scene = (dmax - dmin)[:, None]
    sizes = np.broadcast_to(np.float32([0.6, 0.6, 0.9]), (D, n, 3)).copy()
    valid = np.ones((D, n), bool)
    valid[:, 3::7] = False
    return dict(feats=(rng.randn(D, n, C) * 0.3).astype(np.float32), xyz=xyz,
                dmin=dmin, dmax=dmax, valid=valid, enc_pred={
                    "center_unnormalized": xyz,
                    "center_normalized": (xyz - dmin[:, None]) / scene,
                    "size_unnormalized": sizes,
                    "size_normalized": sizes / scene})


def jax_seq_step(jcfg, params, stats, batch):
    """JAX's `Trainer.train_step` at (2, 2) from (params, stats), its
    optimizer chained after a transformation that keeps the gradients
    (after the engine's psum over "seq" and pmean over "data") in its
    state, its criterion adding each data row's train-mode outputs to the
    loss dict in that row's slot (the engine pmeans the dict over "data":
    D times the mean is the row). Returns (loss, loss dict, gradients,
    parameters after the update, batch statistics, {key: outputs (D,
    ...)})."""
    mesh = make_mesh(jcfg.mesh_axis_names, jcfg.mesh_shape,
                     devices=jax.devices()[:D * S])
    model = build_jax_model(jcfg, JaxScannetConfig(),
                            axis_name=jcfg.mesh_axis_names)
    trainer = JaxTrainer(jcfg, model, JaxScannetConfig(), mesh, 1)
    criterion = trainer.criterion

    def with_outputs(out, batch):
        loss, parts = criterion(out, batch)
        d = jax.lax.axis_index("data")
        for k in OUTPUT_KEYS:
            x = out["outputs"][k]
            parts["out:" + k] = jnp.zeros((D,) + x.shape[1:], x.dtype
                                          ).at[d].set(x[0]) * D
        return loss, parts

    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    trainer.criterion = with_outputs
    trainer.tx = optax.chain(keep, trainer.tx)
    trainer._train_step = trainer._build_train_step()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=trainer.tx.init(params))
    new, loss, parts = trainer.train_step(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), retries=0)
    parts = jax.tree.map(np.asarray, dict(parts))
    outs = {k[4:]: parts.pop(k) for k in list(parts) if k.startswith("out:")}
    return jax.tree.map(np.asarray, (loss, parts, new.opt_state[0],
                                     new.params, new.batch_stats)) + (outs,)


def jax_seq_eval(jcfg, params, stats, batch):
    mesh = make_mesh(jcfg.mesh_axis_names, jcfg.mesh_shape,
                     devices=jax.devices()[:D * S])
    model = build_jax_model(jcfg, JaxScannetConfig(),
                            axis_name=jcfg.mesh_axis_names)
    trainer = JaxTrainer(jcfg, model, JaxScannetConfig(), mesh, 1)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=None)
    out = trainer.eval_step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, retries=0)
    return jax.tree.map(np.asarray, dict(out))


def jax_seq_decoder(jcfg, params, stats, dec):
    ds = JaxScannetConfig()
    mesh = make_mesh(("seq",), (S,), devices=jax.devices()[:S])
    m = TransformerDecoder(jcfg, ds.num_semcls, ds.num_angle_bin,
                           np.asarray(ds.mean_size_arr, np.float32))
    v = {"params": params["decoder"], "batch_stats": stats["decoder"]}

    def local(v, feats, xyz, dmin, dmax, enc_pred, valid):
        return m.apply(v, feats, xyz, [dmin, dmax], enc_pred,
                       enc_valid=valid)

    sh = P(None, "seq")
    f = jax.jit(shard_map(local, mesh=mesh,
                          in_specs=(P(), sh, sh, P(), P(), sh, sh),
                          out_specs=P(), check_vma=False))
    out = f(v, *[jnp.asarray(dec[k]) for k in ("feats", "xyz", "dmin",
                                                 "dmax")],
            {k: jnp.asarray(x) for k, x in dec["enc_pred"].items()},
            jnp.asarray(dec["valid"]))
    return jax.tree.map(np.asarray, out)


def jax_eval_side(jcfg, params, stats, dec, batch):
    """JAX's seq decoder and its test_only eval step (a spawned process's
    work)."""
    return (jax_seq_decoder(jcfg, params, stats, dec),
            jax_seq_eval(jcfg.replace(test_only=True,
                                      empty_pt_thre=EMPTY_PT_THRE),
                         params, stats, batch))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's four ranks, started first (spawned processes, waited on
    in a thread), JAX's decoder and eval step in a spawned process and its
    train step in this one: {"ranks", "jax_step", "jax_eval", "jax_dec",
    "batch", "params", "dec"}."""
    tmp = tmp_path_factory.mktemp("seq_model")
    batch = scenes()
    jcfg = JaxConfig(**SEQ_TINY, **MESH)
    shapes = flax_shapes(VDETRConfig(**SEQ_TINY), ScannetDatasetConfig())
    rng = np.random.RandomState(5)
    params = _random_tree(shapes["params"], rng)
    stats = _random_tree(shapes["batch_stats"], rng, stats=True)
    cfg = VDETRConfig(**SEQ_TINY, **MESH)
    port = build_model(VDETRConfig(**SEQ_TINY), ScannetDatasetConfig(),
                       device="cpu")
    load_jax_params(port, params, stats, VDETRConfig(**SEQ_TINY))
    state = str(tmp / "state.pt")
    torch.save(port.state_dict(), state)
    dec = decoder_inputs()
    res = {"batch": batch, "params": params, "dec": dec}

    def ranks():
        res["ranks"] = run_ranks(seq_model_rank, D * S, dict(
            world=D * S, init_method=f"file://{tmp}/rdzv",
            timeout=datetime.timedelta(seconds=180), cfg=cfg,
            eval_cfg=cfg.replace(test_only=True,
                                 empty_pt_thre=EMPTY_PT_THRE),
            state=state, batch=batch, decoder=dec,
            output_keys=OUTPUT_KEYS), 400)

    # JAX's decoder and eval step in a spawned process (tracing holds the
    # interpreter lock), its train step here, while the ranks run
    spawn = multiprocessing.get_context("spawn")
    rank_thread = threading.Thread(target=ranks)
    rank_thread.start()
    try:
        with ProcessPoolExecutor(max_workers=1, mp_context=spawn) as procs:
            jax_eval = procs.submit(jax_eval_side, jcfg, params, stats, dec,
                                    batch)
            res["jax_step"] = jax_seq_step(jcfg, params, stats, batch)
            res["jax_dec"], res["jax_eval"] = jax_eval.result()
    finally:
        rank_thread.join()
    missing = {"ranks", "jax_dec", "jax_eval"} - set(res)
    assert not missing, f"{missing} failed (see the log above)"
    return res


def test_ranks_form_the_grid(runs):
    assert [r["grid"] for r in runs["ranks"]] == [
        (D, S, r // S, r % S) for r in range(D * S)]


def test_seq_decoder_matches_jax(runs):
    want = runs["jax_dec"]
    for r in runs["ranks"]:
        got = r["decoder"]
        for key in ("sem_cls_logits", "center_unnormalized",
                    "objectness_prob", "box_corners"):
            np.testing.assert_allclose(got["outputs"][key].numpy(),
                                       want["outputs"][key], atol=ATOL,
                                       rtol=RTOL, err_msg=key)
        assert len(got["aux_outputs"]) == len(want["aux_outputs"])
        for a, b in zip(got["aux_outputs"], want["aux_outputs"]):
            # aux0 is every seed's, gathered from the shards
            assert a["sem_cls_logits"].shape[1] == b["sem_cls_logits"].shape[1]
            np.testing.assert_allclose(a["sem_cls_logits"].numpy(),
                                       b["sem_cls_logits"], atol=ATOL,
                                       rtol=RTOL)
    assert want["aux_outputs"][0]["sem_cls_logits"].shape[1] == DEC_SEEDS


def test_jax_seq_step_gradients_are_s_times_exact():
    """JAX's recipe (pmean of the loss over "seq", psum of the gradients
    over "seq") on L(w) = (w sum_s x_s)^2 + w, x sharded: the exact
    dL/dw is 2 w (sum x)^2 + 1 = 55 at w = 3, x = (1, 2); JAX gives S
    times it."""
    mesh = make_mesh(("seq",), (S,), devices=jax.devices()[:S])

    def per(w, x):
        def lf(w):
            s = jax.lax.psum(w * x.sum(), "seq")
            return jax.lax.pmean(s ** 2 + w, "seq")

        return jax.lax.psum(jax.grad(lf)(w), "seq")

    g = jax.jit(shard_map(per, mesh=mesh, in_specs=(P(), P("seq")),
                          out_specs=P(), check_vma=False))(
        jnp.float32(3.0), jnp.float32([1.0, 2.0]))
    assert float(g) == S * 55.0


def _reference(runs):
    """JAX's step as the port takes it: gradients / S, clipped as the
    port clips; the loss, parts, parameters and statistics as they are."""
    loss, parts, grads, new_params, new_stats, outs = runs["jax_step"]
    grads = {k: v / S for k, v in flat_tree(grads).items()}
    gnorm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                              for g in grads.values())))
    clip = min(1.0, VDETRConfig(**TINY).clip_gradient / gnorm)
    return dict(loss=float(loss), parts={k: float(v) for k, v in
                                         parts.items()},
                grads={k: v * clip for k, v in grads.items()},
                params=flat_tree(new_params), stats=flat_tree(new_stats),
                gnorm=gnorm, outs=outs)


def test_seq_train_step_matches_jax(runs):
    ref = _reference(runs)
    # past the clip on both sides, so that AdamW takes the same update
    # from JAX's S-times gradients as from the port's
    assert ref["gnorm"] > VDETRConfig().clip_gradient
    cfg = VDETRConfig(**SEQ_TINY)
    t = runs["ranks"][0]["train"]  # the others: bit-equal to it, below
    stats = {k: v for k, v in t["buffers"].items()
             if k.endswith(("running_mean", "running_var"))}
    params, stats, _ = jax_trees({**t["params"], **stats}, cfg)
    check_against_jax(ref, dict(
        loss=t["loss"], parts=t["parts"],
        grads=flat_tree(jax_trees(t["grads"], cfg)[0]),
        params=flat_tree(params), stats=flat_tree(stats)))


def test_seq_train_outputs_match_jax(runs):
    ref = _reference(runs)["outs"]
    for r in runs["ranks"]:
        d = r["grid"][2]
        for k in OUTPUT_KEYS:
            np.testing.assert_allclose(r["train"]["outputs"][k].numpy(),
                                       ref[k][d:d + 1], atol=ATOL, rtol=RTOL,
                                       err_msg=k)


def test_seq_ranks_bit_equal_after_the_step(runs):
    first = runs["ranks"][0]["train"]
    for r in runs["ranks"][1:]:
        assert r["train"]["loss"] == first["loss"]
        for part in ("grads", "params", "buffers"):
            for n, v in first[part].items():
                assert torch.equal(v, r["train"][part][n]), (part, n)


def test_seq_eval_step_matches_jax(runs):
    want = runs["jax_eval"]
    for r in runs["ranks"]:
        d = r["grid"][2]
        got = r["eval"]
        assert set(got) == set(want)
        for k, v in got.items():
            if v.dtype == torch.bool:
                np.testing.assert_array_equal(v.numpy(), want[k][d:d + 1],
                                              err_msg=k)
            else:
                np.testing.assert_allclose(v.numpy(), want[k][d:d + 1],
                                           atol=ATOL, rtol=RTOL, err_msg=k)
    # every rank returns seq rank 0's outputs
    for r in runs["ranks"]:
        twin = runs["ranks"][r["grid"][2] * S]["eval"]
        assert all(torch.equal(v, twin[k]) for k, v in r["eval"].items())


def test_jax_seq_eval_counts_points_of_seq_rank_0_only(runs):
    """The empty-box removal of JAX's seq eval step reads the point block
    of seq rank 0 (`batch["point_clouds"]` inside its `shard_map`), not
    the scene: its keep mask is the one from block 0's counts, and the
    scene's counts would keep other boxes."""
    cfg = VDETRConfig(**SEQ_TINY, test_only=True,
                      empty_pt_thre=EMPTY_PT_THRE)
    plain = Trainer(cfg, build_model(cfg, ScannetDatasetConfig(),
                                     device="cpu"),
                    ScannetDatasetConfig(), 1, device="cpu")
    batch = runs["batch"]
    want = runs["jax_eval"]["nms_keep"]
    differs = False
    for d in range(D):
        out = {k: v.clone() for k, v in runs["ranks"][d * S]["eval"].items()}
        pc = torch.from_numpy(batch["point_clouds"][d:d + 1])
        block0 = torch.from_numpy(seq_block(
            {"point_clouds": batch["point_clouds"][d:d + 1]}, 0,
            S)["point_clouds"])
        keep0 = plain._nms_keep(out, block0)
        np.testing.assert_array_equal(keep0.numpy(), want[d:d + 1])
        differs |= not torch.equal(plain._nms_keep(out, pc), keep0)
    assert differs


def test_seq_config_never_runs_dense():
    cfg = VDETRConfig(**SEQ_TINY, **MESH)
    ds = ScannetDatasetConfig()
    model = build_model(cfg, ds, device="cpu")
    batch = scenes()
    with pytest.raises(ValueError, match="seq group"):
        model({k: torch.from_numpy(batch[k]) for k in INPUT_KEYS
               if k in batch})
    with pytest.raises(ValueError, match="world has 1"):
        Trainer(cfg, model, ds, 1, device="cpu")
    # a seq axis of one rank is the dense model
    one = VDETRConfig(**SEQ_TINY, mesh_axis_names=("data", "seq"),
                      mesh_shape=(1, 1))
    trainer = Trainer(one, build_model(one, ds, device="cpu"), ds, 1,
                      device="cpu")
    assert trainer.grid.seq is None
    # the CLI takes the mesh from the caller and refuses a world that is
    # not its size
    argv = ["--dataset_name", "synthetic", "--max_epoch", "1"]
    for k, v in SEQ_TINY.items():
        if k != "grid_extent":
            argv += [f"--{k}", str(int(v) if isinstance(v, bool) else v)]
    with pytest.raises(ValueError, match="1 x 2 ranks, but the world has 1"):
        main(argv, device="cpu", mesh_axis_names=("data", "seq"),
             mesh_shape=(1, 2))
