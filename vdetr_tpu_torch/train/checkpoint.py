"""Checkpoint save / resume, and reading the JAX package's checkpoints
(torch counterpart of `vdetr_tpu/train/checkpoint.py`; reference
utils/io.py).

A checkpoint is a directory, laid out as the JAX package lays it out
(`checkpoint` every epoch, `checkpoint_best`, numbered
`checkpoint_%04d`): `state.pt`, a `torch.save` of the model's state_dict
(the reference's names, the port's layouts), the AdamW state and the
train step, beside `header.json`, the JAX package's header: the epoch,
the best metrics, the whole config and `format_version`. The header is
what `--auto_test` reads, from a port or a JAX checkpoint alike.

A JAX checkpoint directory holds `state.msgpack` instead, written by
`flax.serialization.msgpack_serialize`. This module reads it with a
decoder of its own for the subset that writer produces (maps, arrays,
strings, bytes, ints, floats, bools, nil and the ndarray and numpy
scalar ext types, with flax's chunked arrays), so the port needs neither
flax nor msgpack; its params and batch_stats load through
`convert.load_jax_params`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vdetr_tpu_torch.config import AUTO_TEST_IGNORE_KEYS, VDETRConfig

STATE_FILE = "state.pt"
JAX_STATE_FILE = "state.msgpack"
HEADER_FILE = "header.json"
LATEST = "checkpoint"
BEST = "checkpoint_best"


def save_checkpoint(checkpoint_dir: str, trainer, cfg: VDETRConfig,
                    epoch: int, best_val_metrics: Optional[Dict] = None,
                    filename: str = LATEST) -> str:
    """Write `trainer`'s model, AdamW state and step, and the header, to
    `<checkpoint_dir>/<filename>/`. Returns that directory."""
    path = os.path.join(checkpoint_dir, filename)
    os.makedirs(path, exist_ok=True)
    state = {"model": {k: v.detach().cpu() for k, v in
                       trainer.model.state_dict().items()},
             "optimizer": trainer.optimizer.state_dict(),
             "step": trainer.step}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    header = {
        "epoch": epoch,
        "best_val_metrics": best_val_metrics or {},
        "config": dataclasses.asdict(cfg),
        "format_version": 1,
    }
    with open(os.path.join(path, HEADER_FILE), "w") as f:
        json.dump(header, f, indent=1, default=str)
    return path


def read_header(path: str) -> Dict:
    with open(os.path.join(path, HEADER_FILE)) as f:
        return json.load(f)


def load_checkpoint(path: str, trainer) -> Dict:
    """Load a port checkpoint directory into `trainer` (model, AdamW state,
    step). Returns the header."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    trainer.model.load_state_dict(state["model"], strict=True)
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.step = int(state["step"])
    return read_header(path)


def is_jax_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, JAX_STATE_FILE))


def load_jax_checkpoint(path: str, model, cfg: VDETRConfig) -> Dict:
    """Load the params and batch_stats of a JAX checkpoint directory into
    `model` (every tensor of the port covered). Returns the header."""
    from vdetr_tpu_torch.convert import load_jax_params

    with open(os.path.join(path, JAX_STATE_FILE), "rb") as f:
        tree = msgpack_restore(f.read())
    load_jax_params(model, tree["params"], tree.get("batch_stats", {}), cfg)
    return read_header(path)


def load_config(path: str) -> Tuple[VDETRConfig, Dict]:
    header = read_header(path)
    raw = dict(header["config"])
    # JSON round-trips tuples as lists
    for k in ("grid_extent", "mesh_shape", "mesh_axis_names"):
        if k in raw and isinstance(raw[k], list):
            raw[k] = tuple(raw[k])
    # None fields serialized as the string "None" via default=str
    for k, v in raw.items():
        if v == "None":
            raw[k] = None
    return VDETRConfig(**raw), header


def auto_reload_config(cli_cfg: VDETRConfig, ckpt_path: str) -> VDETRConfig:
    """--auto_test: take model hyperparams from the checkpoint, keep
    test/NMS/IO flags from the CLI (reference main.py:218-233)."""
    ckpt_cfg, _ = load_config(ckpt_path)
    merged = dataclasses.asdict(ckpt_cfg)
    cli = dataclasses.asdict(cli_cfg)
    for k in AUTO_TEST_IGNORE_KEYS:
        if k in cli:
            merged[k] = cli[k]
    return VDETRConfig(**merged)


def resume_if_possible(checkpoint_dir: Optional[str], trainer):
    """Reference utils/io.py:33-58: resume from `<dir>/checkpoint` when it
    exists. Returns (last epoch, best_val_metrics): (-1, {}) when there is
    nothing to resume."""
    if not checkpoint_dir:
        return -1, {}
    path = os.path.join(checkpoint_dir, LATEST)
    if not os.path.isfile(os.path.join(path, STATE_FILE)):
        return -1, {}
    header = load_checkpoint(path, trainer)
    return int(header.get("epoch", -1)), header.get("best_val_metrics", {})


# --------------------------------------------------------------------------
# msgpack, the subset flax.serialization.msgpack_serialize writes
# --------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """A msgpack decoder over one buffer (https://msgpack.org/ spec)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "ext":
                return self.ext(n)
            return getattr(self, kind)(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, buf = _Reader(payload).value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        if dtype == "bfloat16":
            raise ValueError("msgpack: bfloat16 arrays are not read")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr.copy()


def _unchunk(tree):
    """flax's chunked form of arrays past 1 GiB back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The tree that `flax.serialization.msgpack_restore` returns for
    `data`: nested dicts with numpy array leaves."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.at != len(reader.data):
        raise ValueError("msgpack: trailing bytes")
    return _unchunk(tree)
