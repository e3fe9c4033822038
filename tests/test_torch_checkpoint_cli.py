"""The port's checkpoints and CLI against the JAX package on the CPU.

- The msgpack decoder of `train/checkpoint.py` gives the tree that
  `flax.serialization.msgpack_restore` gives (every leaf equal, chunked
  arrays included).
- A JAX checkpoint directory (`vdetr_tpu.train.checkpoint.save_checkpoint`
  of a tiny train state) loads into the port with every tensor equal to
  the weight bridge's load of the same trees; `auto_reload_config` gives
  JAX's config.
- A reference-layout `.pth` (the reference's names and kernel-offset
  order, its args pickled beside) loads with every tensor equal, and
  `reference_args_to_config` gives JAX's config.
- A port checkpoint saved after epoch 0 and resumed gives the epoch 1 of
  an unbroken run, losses and every tensor bit for bit (dropout on).
- `python -m vdetr_tpu_torch.main` at a tiny config, as
  tests/test_main_cli.py drives the JAX CLI: train, `checkpoint` and
  `checkpoint_best`, `final_eval.*`, `--test_only --auto_test` on
  `checkpoint_best` reproducing the final eval's mAP exactly (with
  `--empty_pt_thre 0`, so that the test-only pass's empty-box removal
  keeps every box, as the training loop's passes do), then `--tta`.

The train-step tests run torch on one thread: the tier-1 run has six
workers on the machine's cores, and torch's intra-op pool in each of
them oversubscribes the cores, which slows the CLI's thousands of small
ops by an order of magnitude.
"""

import argparse
import dataclasses
import os
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import _random_tree
from vdetr_tpu.config import AUTO_TEST_IGNORE_KEYS as JAX_IGNORE
from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.data import ScannetDatasetConfig as JaxScannetConfig
from vdetr_tpu.main import make_args_parser as jax_parser
from vdetr_tpu.models import build_model as build_jax_model
from vdetr_tpu.train import checkpoint as jax_ckpt
from vdetr_tpu.train.engine import TrainState
from vdetr_tpu.train.optimizer import build_optimizer as jax_optimizer
from vdetr_tpu.train.schedule import make_lr_schedule
from vdetr_tpu.train.torch_import import \
    reference_args_to_config as jax_args_to_config
from vdetr_tpu_torch.config import AUTO_TEST_IGNORE_KEYS, VDETRConfig
from vdetr_tpu_torch.convert import (load_jax_params,
                                     reference_args_to_config,
                                     reference_state_dict)
from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
from vdetr_tpu_torch.data.loader import prefetch_loader
from vdetr_tpu_torch.data.synthetic import SyntheticDetectionDataset
from vdetr_tpu_torch.main import (_load_reference_weights,
                                  _reference_checkpoint, make_args_parser,
                                  main)
from vdetr_tpu_torch.models.vdetr import build_model
from vdetr_tpu_torch.train import checkpoint as ckpt_io
from vdetr_tpu_torch.train.engine import (Trainer, epoch_generator,
                                          train_one_epoch)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


TINY = dict(
    voxel_capacity=2048, min_stage_capacity=128, grid_extent=(128, 128, 64),
    voxel_size=0.05, preenc_npoints=64, nqueries=32, dec_nlayers=2,
    dec_dim=32, dec_ffn_dim=32, rpe_dim=8, inplanes=8, enc_dim=32,
    fps_impl="jax", num_points=512, repeat_num=2)
# the CLI at the JAX CLI test's tiny config (tests/test_main_cli.py), 32
# queries so that the GT copies (up to 10 objects x 2) fit the proposals
CLI_TINY = [
    "--dataset_name", "synthetic",
    "--voxel_capacity", "1024", "--min_stage_capacity", "128",
    "--preenc_npoints", "64", "--nqueries", "32",
    "--dec_nlayers", "2", "--dec_dim", "32", "--dec_ffn_dim", "32",
    "--rpe_dim", "8", "--inplanes", "8", "--enc_dim", "32",
    "--fps_impl", "jax", "--num_points", "512", "--repeat_num", "2",
    "--mlp_dropout", "0", "--dec_dropout", "0",
    "--batchsize_per_gpu", "8", "--dataset_num_workers", "0",
]


def leaves_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            leaves_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            leaves_equal(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_msgpack_decoder_equals_flax(monkeypatch):
    rng = np.random.RandomState(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                 2 ** 40, -1, -32, -33, -128, -129, -40000, -2 ** 40],
        "floats": [0.5, -1e30, 3.14159],
        "flags": [True, False, None],
        "text": ["", "a" * 31, "b" * 32, "c" * 300, "été"],
        "blob": b"\x00\x01" * 200,
        "wide": {f"k{i}": i for i in range(20)},
        "long": list(range(20)),
        "arrays": {
            "f32": rng.randn(3, 4).astype(np.float32),
            "i32": rng.randint(-9, 9, (5,)).astype(np.int32),
            "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
            "u8": np.arange(7, dtype=np.uint8),
            "b": rng.rand(4) > 0.5,
            "empty": np.zeros((0, 3), np.float32),
            "zero_d": np.array(2.5, np.float32),
            "scalar": np.float32(1.25),
            "big": rng.randn(40, 8).astype(np.float32),
        },
    }
    # arrays past the chunk size (1 GiB in flax) go in chunks
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    blob = flax.serialization.msgpack_serialize(tree)
    leaves_equal(ckpt_io.msgpack_restore(blob),
                 flax.serialization.msgpack_restore(blob))


def jax_tiny_state(seed=1):
    jcfg = JaxConfig(**TINY)
    jm = build_jax_model(jcfg, JaxScannetConfig())
    data = SyntheticDetectionDataset(ScannetDatasetConfig(), 512,
                                     num_scenes=1, seed=0)[0]
    inp = {k: jnp.asarray(data[k])[None] for k in (
        "point_clouds", "point_cloud_dims_min", "point_cloud_dims_max",
        "point_validity")}
    shapes = jax.eval_shape(lambda k, i: jm.init(k, i, train=False),
                            jax.random.PRNGKey(0), inp)
    rng = np.random.RandomState(seed)
    params = _random_tree(shapes["params"], rng)
    stats = _random_tree(shapes["batch_stats"], rng, stats=True)
    tx = jax_optimizer(jcfg, make_lr_schedule(jcfg, 10))
    state = TrainState(step=jnp.asarray(7, jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params))
    return jcfg, state, params, stats


def test_jax_checkpoint_loads_with_every_tensor_equal(tmp_path):
    jcfg, state, params, stats = jax_tiny_state()
    path = jax_ckpt.save_checkpoint(str(tmp_path), state, jcfg, 3,
                                    {"mAP_0.25": 0.5})
    cfg = VDETRConfig(**TINY)
    got = build_model(cfg, ScannetDatasetConfig(), device="cpu")
    header = ckpt_io.load_jax_checkpoint(path, got, cfg)
    assert header["epoch"] == 3
    want = load_jax_params(build_model(cfg, ScannetDatasetConfig(),
                                       device="cpu"), params, stats, cfg)
    sd_got, sd_want = got.state_dict(), want.state_dict()
    assert set(sd_got) == set(sd_want)
    for k, v in sd_want.items():
        assert torch.equal(sd_got[k], v), k
    # --auto_test: the model's flags from the header, the CLI's the rest
    cli = dict(test_only=True, auto_test=True, nms_iou=0.3, dec_nlayers=4,
               test_ckpt=path)
    got_cfg = ckpt_io.auto_reload_config(VDETRConfig(**cli), path)
    want_cfg = jax_ckpt.auto_reload_config(JaxConfig(**cli), path)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert got_cfg.dec_nlayers == 2 and got_cfg.nms_iou == 0.3
    assert AUTO_TEST_IGNORE_KEYS == JAX_IGNORE


def test_reference_pth_loads_with_every_tensor_equal(tmp_path):
    cfg = VDETRConfig(**TINY)
    src = build_model(cfg, ScannetDatasetConfig(), device="cpu",
                      generator=torch.Generator().manual_seed(5))
    args = argparse.Namespace(dec_nlayers=2, enc_dim=32, nms_iou=0.1,
                              ngpus=8, angle_type=None, dist_url="x")
    pth = tmp_path / "ref.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          reference_state_dict(src).items()},
                "args": args, "epoch": 9}, pth)
    # the CLI's path: --test_only --auto_test --test_ckpt ref.pth
    base = dict(TINY, angle_type="x", nms_iou=0.4, dec_nlayers=3,
                test_only=True, auto_test=True, test_ckpt=str(pth))
    ckpt, got_cfg = _reference_checkpoint(VDETRConfig(**base))
    want_cfg = jax_args_to_config(args, JaxConfig(**base), JAX_IGNORE)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert got_cfg == reference_args_to_config(
        args, VDETRConfig(**base), AUTO_TEST_IGNORE_KEYS)
    assert got_cfg.dec_nlayers == 2 and got_cfg.nms_iou == 0.4
    got = build_model(got_cfg, ScannetDatasetConfig(), device="cpu")
    _load_reference_weights(got, ckpt)
    for k, v in src.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


def test_resume_gives_the_unbroken_epoch_bit_for_bit(tmp_path):
    cfg = VDETRConfig(**TINY, max_epoch=2, warm_lr_epochs=1)
    ds = ScannetDatasetConfig()
    data = SyntheticDetectionDataset(ds, 512, num_scenes=4, seed=2)

    def fresh(seed):
        model = build_model(cfg, ds, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
        return Trainer(cfg, model, ds, steps_per_epoch=2, device="cpu")

    class Losses(list):  # a metrics logger that keeps every step's loss
        def log(self, metrics, step, prefix=""):
            self.append((step, metrics["loss"]))

    def epoch(trainer, e):
        losses = Losses()
        loader = prefetch_loader(data, 2, seed=cfg.seed + e)
        train_one_epoch(trainer, loader, e, epoch_generator(trainer, e),
                        logger=None, metrics_logger=losses,
                        log_metrics_every=1)
        return losses

    unbroken = fresh(0)
    epoch(unbroken, 0)
    want = epoch(unbroken, 1)

    first = fresh(0)
    epoch(first, 0)
    ckpt_io.save_checkpoint(str(tmp_path), first, cfg, 0, {})
    resumed = fresh(1)  # other weights: the checkpoint must replace them
    last, best = ckpt_io.resume_if_possible(str(tmp_path), resumed)
    assert (last, best) == (0, {})
    assert epoch(resumed, 1) == want  # (step, loss) of each step
    assert resumed.step == unbroken.step == 4
    for k, v in unbroken.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for a, b in zip(unbroken.optimizer.state.values(),
                    resumed.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_one_epoch_traces_iterations_2_to_4_of_epoch_0(tmp_path):
    """`profile_dir`: torch.profiler is on for iterations 2-4 of epoch 0
    (the JAX package's jax.profiler window), its trace written; an epoch
    shorter than the window still closes it; other epochs run bare."""
    class Stub:  # the trainer interface train_one_epoch uses
        device, step = torch.device("cpu"), 0

        def __init__(self):
            self.seen = []

        def train_step(self, batch, generator):
            self.seen.append(torch._C._autograd._profiler_enabled())
            self.step += 1
            return float(torch.ones(2).sum()), {}

        def current_lr(self):
            return 0.0

    for epoch, n, want in ((0, 7, [0, 0, 1, 1, 1, 0, 0]), (0, 3, [0, 0, 1]),
                           (1, 7, [0] * 7)):
        out = tmp_path / f"trace_{epoch}_{n}"
        stub = Stub()
        train_one_epoch(stub, range(n), epoch, logger=None,
                        profile_dir=str(out))
        assert stub.seen == [bool(w) for w in want]
        assert (out / "trace.json").is_file() == (epoch == 0)


def test_cli_flags_are_the_jax_clis():
    got = {a.dest: a.default for a in make_args_parser()._actions
           if a.dest != "help"}
    want = {a.dest: a.default for a in jax_parser()._actions
            if a.dest != "help"}
    assert got == want


def test_cli_train_checkpoint_auto_test_and_tta(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    overall = main(CLI_TINY + ["--max_epoch", "1", "--checkpoint_dir",
                               ckpt_dir, "--eval_every_epoch", "10"],
                   device="cpu")
    assert 0.25 in overall and np.isfinite(overall[0.25]["mAP"])
    for d in ("checkpoint", "checkpoint_best"):
        assert os.path.isfile(os.path.join(ckpt_dir, d, "state.pt"))
        assert os.path.isfile(os.path.join(ckpt_dir, d, "header.json"))
    assert os.path.isfile(os.path.join(ckpt_dir, "final_eval.txt"))
    with open(os.path.join(ckpt_dir, "final_eval.pkl"), "rb") as f:
        pkl = pickle.load(f)
    assert pkl[0.25]["mAP"] == overall[0.25]["mAP"]

    best = os.path.join(ckpt_dir, "checkpoint_best")
    # --auto_test restores the model's flags: the CLI names none of them.
    # --test_only adds empty-box removal to the eval (the training loop's
    # passes run without it, as in the JAX package); at --empty_pt_thre 0
    # it keeps every box, so the two passes compute the same function
    again = main(["--dataset_name", "synthetic", "--test_only", "1",
                  "--auto_test", "1", "--test_ckpt", best,
                  "--empty_pt_thre", "0", "--dataset_num_workers", "0"],
                 device="cpu")
    for t in (0.25, 0.5):
        assert again[t]["mAP"] == overall[t]["mAP"]

    tta = main(CLI_TINY + ["--test_only", "1", "--tta", "1",
                           "--test_ckpt", best], device="cpu")
    assert 0.25 in tta and np.isfinite(tta[0.25]["mAP"])
