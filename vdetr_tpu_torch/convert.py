"""Weight bridge between the JAX package's parameter trees and the port,
and between the reference's checkpoints and the port.

The port's parameters are named after the reference V-DETR state_dict.
`build_reference_state_dict` renames a flax (params, batch_stats) tree,
as numpy arrays, to those names; it is this package's own copy of the
mapping in `vdetr_tpu/train/torch_import.py` (for the BasicBlock depths
the port builds), so that the port imports nothing of the JAX package.
Linear and 1x1 kernels are transposed to torch's (out, in) layout and
the packed self-attention in_proj is rebuilt from q/k/v.

Sparse-conv kernel offsets: the reference layout (MinkowskiEngine) is
x-fastest, the JAX package and the port are z-fastest, so
`k_port = k_ref[KERNEL_OFFSET_PERMUTATION[k^3]]`: the base-k digit
reversal, an involution (torch_import.py:32-85 derives it).

`reference_args_to_config` maps the argparse namespace pickled in a
reference checkpoint onto `VDETRConfig`, for `--test_only --auto_test
--test_ckpt x.pth` (the port's copy of torch_import.py:332-358).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from vdetr_tpu_torch.config import VDETRConfig


def _digit_reversal_perm(kernel_size: int) -> np.ndarray:
    """perm[our z-fastest index] = ME x-fastest index, same offset."""
    k = kernel_size
    perm = np.empty(k ** 3, np.int64)
    for ix in range(k):
        for iy in range(k):
            for iz in range(k):
                perm[(ix * k + iy) * k + iz] = (iz * k + iy) * k + ix
    return perm


KERNEL_OFFSET_PERMUTATION: Dict[int, np.ndarray] = {
    27: _digit_reversal_perm(3),
    8: _digit_reversal_perm(2),
}

Path = Tuple[str, ...]


class _NameMap:
    """Records, for each reference tensor name, the flax path it comes
    from and how it is laid out (the forward mapping of torch_import's
    `_Mapper`, run without data)."""

    def __init__(self):
        self.params: Dict[str, Tuple[Path, str]] = {}
        self.stats: Dict[str, Path] = {}

    def linear(self, tname, path, bias=True):
        self.params[tname + ".weight"] = (path + ("kernel",), "linear_w")
        if bias:
            self.params[tname + ".bias"] = (path + ("bias",), "raw")

    def conv1d(self, tname, path, bias=True):
        self.params[tname + ".weight"] = (path + ("kernel",), "conv1d_w")
        if bias:
            self.params[tname + ".bias"] = (path + ("bias",), "raw")

    def norm(self, tname, path, stats=True):
        """BatchNorm (with running stats) or LayerNorm (without)."""
        self.params[tname + ".weight"] = (path + ("scale",), "raw")
        self.params[tname + ".bias"] = (path + ("bias",), "raw")
        if stats:
            self.stats[tname + ".running_mean"] = path + ("mean",)
            self.stats[tname + ".running_var"] = path + ("var",)

    def mink_kernel(self, tname, path):
        self.params[tname + ".kernel"] = (path + ("kernel",), "mink")

    def raw(self, tname, path):
        self.params[tname] = (path, "raw")

    def packed_qkv(self, tname, path):
        self.params[tname + ".in_proj_weight"] = (path + ("q", "kernel"),
                                                  "packed_qkv")
        self.params[tname + ".in_proj_bias"] = (path + ("q", "bias"),
                                                "packed_qkv_bias")


def _map_generic_mlp(m: _NameMap, tname: str, path, n_hidden: int = 2):
    """GenericMLP Sequential indices: conv, bn, act, dropout per hidden
    layer, then the output conv (reference models/helpers.py:102-128)."""
    idx = 0
    for h in range(n_hidden):
        m.conv1d(f"{tname}.layers.{idx}", path + (f"layer{h}",), bias=False)
        m.norm(f"{tname}.layers.{idx + 1}", path + (f"norm{h}",))
        idx += 4
    m.conv1d(f"{tname}.layers.{idx}", path + ("out",))


def _map_proj(m: _NameMap, cfg: VDETRConfig):
    base = "encoder_to_decoder_projection"
    path = (base,)
    if cfg.proj_nohid:
        # [conv (no bias), bn, relu]
        m.conv1d(f"{base}.layers.0", path + ("out",), bias=False)
        m.norm(f"{base}.layers.1", path + ("normout",))
    else:
        m.conv1d(f"{base}.layers.0", path + ("layer0",), bias=False)
        m.norm(f"{base}.layers.1", path + ("norm0",))
        m.conv1d(f"{base}.layers.4", path + ("out",), bias=False)
        m.norm(f"{base}.layers.5", path + ("normout",))


def _map_pos_embed(m: _NameMap, tname: str, path):
    """PositionEmbeddingLearned: conv(0), bn(1), relu(2), conv(3)
    (reference models/helpers.py:22-28)."""
    m.conv1d(f"{tname}.position_embedding_head.0", path + ("layer0",))
    m.norm(f"{tname}.position_embedding_head.1", path + ("norm0",))
    m.conv1d(f"{tname}.position_embedding_head.3", path + ("out",))


def _map_backbone(m: _NameMap, cfg: VDETRConfig):
    arch = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}[cfg.depth]
    p = ("pre_encoder",)
    m.mink_kernel("pre_encoder.conv1", p + ("conv1",))
    m.norm("pre_encoder.norm1.bn" if cfg.stem_bn else "pre_encoder.norm1",
           p + ("norm1",), stats=cfg.stem_bn)
    for i in range(cfg.num_stages):
        for b in range(arch[i]):
            t = f"pre_encoder.layer{i + 1}.{b}"
            q = p + (f"layer{i + 1}_block{b}",)
            for j, cname in enumerate(("conv1", "conv2"), start=1):
                m.mink_kernel(f"{t}.{cname}", q + (cname,))
                m.norm(f"{t}.norm{j}.bn", q + (f"norm{j}",))
            # blocks without a downsample branch have no such flax path
            m.mink_kernel(f"{t}.downsample.0", q + ("downsample_conv",))
            m.norm(f"{t}.downsample.1.bn", q + ("downsample_norm",))


def _map_fpn(m: _NameMap, cfg: VDETRConfig):
    for i in range(cfg.layer_idx + 1, cfg.num_stages):
        t = f"up_block_{i}"
        q = (t,)
        m.mink_kernel(f"{t}.0", q + ("up_conv",))
        m.norm(f"{t}.1.bn", q + ("up_norm",))
        m.mink_kernel(f"{t}.3", q + ("conv",))
        m.norm(f"{t}.4.bn", q + ("norm",))
    t = f"out_block_{cfg.layer_idx}"
    m.mink_kernel(f"{t}.0", (t, "conv"))
    m.norm(f"{t}.1.bn", (t, "norm"))


def _map_decoder(m: _NameMap, cfg: VDETRConfig):
    d = ("decoder",)
    num_layers = cfg.dec_nlayers - 1
    m.linear("decoder.first_layer.linear1", d + ("first_layer", "linear1"))
    m.linear("decoder.first_layer.linear2", d + ("first_layer", "linear2"))
    m.norm("decoder.first_layer.norm", d + ("first_layer", "norm"),
           stats=False)
    m.norm("decoder.norm", d + ("norm",), stats=False)
    if cfg.q_content in ("random", "random_add"):
        m.raw("decoder.query_embed.weight", d + ("query_embed",))
    for i in range(num_layers):
        _map_pos_embed(m, f"decoder.query_pos_projection.{i}",
                       d + (f"query_pos_projection{i}",))
        t = f"decoder.layers.{i}"
        q = d + (f"layer{i}",)
        m.packed_qkv(f"{t}.self_attn", q + ("self_attn",))
        m.linear(f"{t}.self_attn.out_proj", q + ("self_attn", "out_proj"))
        for nm in ("q", "k", "v", "proj"):
            m.linear(f"{t}.multihead_attn.{nm}", q + ("cross_attn", nm))
        for j in range(8):
            m.linear(f"{t}.multihead_attn.cpb_mlps.{j}.0",
                     q + ("cross_attn", f"cpb_mlp{j}", "fc1"))
            m.linear(f"{t}.multihead_attn.cpb_mlps.{j}.2",
                     q + ("cross_attn", f"cpb_mlp{j}", "fc2"), bias=False)
        for n in (1, 2, 3):
            m.norm(f"{t}.norm{n}", q + (f"norm{n}",), stats=False)
        m.linear(f"{t}.linear1", q + ("linear1",))
        m.linear(f"{t}.linear2", q + ("linear2",))
    heads = ["sem_cls", "center", "size", "angle_cls", "angle_residual"]
    for i in range(num_layers + 1):
        for h in heads:
            _map_generic_mlp(m, f"decoder.mlp_heads.{i}.{h}_head",
                             d + (f"mlp_heads{i}", f"{h}_head"))
    _map_generic_mlp(m, "decoder.pointcls_heads", ("pointcls_heads", "head"))


def _flatten(tree, prefix=()) -> Dict[Path, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def build_reference_state_dict(params: Dict, batch_stats: Dict,
                               cfg: VDETRConfig) -> Dict[str, np.ndarray]:
    """A flax (params, batch_stats) tree -> the reference-shaped state
    dict (reference names and layouts, x-fastest kernel offsets)."""
    m = _NameMap()
    _map_backbone(m, cfg)
    _map_fpn(m, cfg)
    _map_proj(m, cfg)
    _map_decoder(m, cfg)
    flat_p, flat_s = _flatten(params), _flatten(batch_stats)
    sd: Dict[str, np.ndarray] = {}
    for tname, (path, kind) in m.params.items():
        if path not in flat_p:
            continue
        v = flat_p[path]
        if kind == "linear_w":
            sd[tname] = v.T
        elif kind == "conv1d_w":
            sd[tname] = v.T[:, :, None]
        elif kind == "mink":
            perm = KERNEL_OFFSET_PERMUTATION.get(v.shape[0])
            sd[tname] = v if perm is None else v[np.argsort(perm)]
        elif kind in ("packed_qkv", "packed_qkv_bias"):
            base, leaf = path[:-2], path[-1]
            qkv = [flat_p[base + (nm, leaf)] for nm in ("q", "k", "v")]
            sd[tname] = np.concatenate(
                [x.T for x in qkv] if kind == "packed_qkv" else qkv, 0)
        else:
            sd[tname] = v
    for tname, path in m.stats.items():
        if path in flat_s:
            sd[tname] = flat_s[path]
    return sd


def _is_offset_kernel(name: str, value) -> bool:
    return name.endswith(".kernel") and value.shape[0] in \
        KERNEL_OFFSET_PERMUTATION


def from_reference_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """Reference-layout state dict -> the port's state dict (kernel
    offsets reordered to z-fastest)."""
    out = {}
    for name, v in sd.items():
        v = np.asarray(v)
        if _is_offset_kernel(name, v):
            v = v[KERNEL_OFFSET_PERMUTATION[v.shape[0]]]
        out[name] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def reference_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    """The port's weights in the reference layout (x-fastest kernel
    offsets), as numpy arrays: the inverse of `from_reference_state_dict`
    and the input the JAX package's `convert_torch_state_dict` expects."""
    out = {}
    for name, v in model.state_dict().items():
        v = v.detach().cpu().numpy()
        if _is_offset_kernel(name, v):
            v = v[np.argsort(KERNEL_OFFSET_PERMUTATION[v.shape[0]])]
        out[name] = v
    return out


def load_jax_params(model: nn.Module, params: Dict, batch_stats: Dict,
                    cfg: VDETRConfig) -> nn.Module:
    """Load flax (params, batch_stats) trees, as numpy arrays, into the
    port. Every tensor of the port must be covered (strict load)."""
    sd = from_reference_state_dict(
        build_reference_state_dict(params, batch_stats, cfg))
    model.load_state_dict(sd, strict=True)
    return model


def reference_args_to_config(ckpt_args, base_cfg: VDETRConfig,
                             ignore_keys=()) -> VDETRConfig:
    """Map the argparse Namespace pickled inside a reference checkpoint
    (`ckpt["args"]`, utils/io.py:23-29) onto VDETRConfig: the .pth
    equivalent of `--auto_test` (reference main.py:218-233).

    Same-named fields are copied; reference-only infra flags (ngpus,
    dist_url, ...) and `ignore_keys` (the test/NMS/IO flags, which stay
    the CLI's) are skipped; fields the reference lacks keep `base_cfg`'s
    values."""
    ns = dict(ckpt_args) if isinstance(ckpt_args, dict) else vars(ckpt_args)
    fields = {f.name for f in dataclasses.fields(VDETRConfig)}
    kw = {}
    for k, v in ns.items():
        if k in ignore_keys or k not in fields:
            continue
        if v is None and isinstance(getattr(base_cfg, k), str):
            v = ""  # argparse default-None strings (angle_type etc.)
        kw[k] = v
    return base_cfg.replace(**kw)
