"""The weights a run hands the program and the reference: drawn on the
device from the seed, in three calls of a `torch.Generator` on the card,
whatever the parameters' order.

- "init" (a training cell): the program's initial scheme
  (`vdetr_tpu_torch/models/vdetr.py:init_weights`): sparse-conv kernels
  truncated-normal with variance 2 / fan_out, dense weights
  Xavier-uniform, the query embedding N(0, 1), norms 1 / 0, biases 0, the
  center and size heads' outputs zero and the focal class heads' output
  bias at the 0.01 prior.
- "trained" (an eval cell): the same, but the center and size heads'
  output layers drawn too, Xavier-uniform times `head_scale`, so that the
  decoder moves the boxes, as a trained checkpoint's does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

FOCAL_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]


def derived_seed(seed: int, tag: int) -> int:
    """A 63-bit seed of (seed, tag); `seed` any whole number >= 0."""
    a, b = np.random.SeedSequence([int(seed), tag]).generate_state(2)
    return (int(a) << 31 ^ int(b)) & (2 ** 63 - 1)


def _last_layers(names: List[str]) -> Dict[str, str]:
    """{prefix: index} of the last layer of each decoder head MLP."""
    last = {}
    for n in names:
        if ".mlp_heads." in n and ".layers." in n:
            prefix, rest = n.split(".layers.")
            idx = int(rest.split(".")[0])
            last[prefix] = max(last.get(prefix, -1), idx)
    return {p: str(i) for p, i in last.items()}


def draw(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, device,
         mode: str = "init", head_scale: float = 0.0,
         center_scale: float = None,
         use_focal: bool = True) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the parameters `shapes` (name, shape).
    `center_scale` (default `head_scale`) scales the centre heads'."""
    names = [n for n, _ in shapes]
    last = _last_layers(names)
    kinds, scale = {}, {}
    for name, shape in shapes:
        leaf = name.rsplit(".", 1)[-1]
        head = next((p for p in last if name.startswith(p + ".layers."
                                                         + last[p] + ".")),
                    None)
        head_kind = head.rsplit(".", 1)[-1] if head else None
        if head_kind in ("center_head", "size_head"):
            kinds[name] = "zero" if mode == "init" else (
                "head" if len(shape) >= 2 else "zero")
            scale[name] = (center_scale if head_kind == "center_head"
                           and center_scale is not None else head_scale)
        elif head_kind == "sem_cls_head" and leaf == "bias" and use_focal:
            kinds[name] = "prior"
        elif leaf == "kernel":
            kinds[name] = "trunc"
        elif name.endswith("query_embed.weight"):
            kinds[name] = "normal"
        elif len(shape) >= 2:
            kinds[name] = "xavier"
        elif leaf == "weight":
            kinds[name] = "one"
        else:
            kinds[name] = "zero"
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 1))
    numel = {n: int(np.prod(s)) for n, s in shapes}
    flat = {}
    for kind in ("trunc", "xavier", "normal"):
        total = sum(numel[n] for n in names
                    if kinds[n] == kind or (kind == "xavier"
                                            and kinds[n] == "head"))
        buf = torch.empty(total, device=device)
        if kind == "trunc":
            torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
        elif kind == "xavier":
            buf.uniform_(-1.0, 1.0, generator=gen)
        else:
            buf.normal_(0.0, 1.0, generator=gen)
        flat[kind] = buf
    at = {"trunc": 0, "xavier": 0, "normal": 0}
    out = {}
    for name, shape in shapes:
        kind = kinds[name]
        src = "xavier" if kind == "head" else kind
        if src in flat:
            n = numel[name]
            x = flat[src][at[src]:at[src] + n].view(shape)
            at[src] += n
            if kind == "trunc":
                fan_out = shape[0] * shape[2]
                x = x * (math.sqrt(2.0 / fan_out) / TRUNC_STD)
            elif kind in ("xavier", "head"):
                fan_out, fan_in = shape[0], n // shape[0]
                x = x * math.sqrt(6.0 / (fan_in + fan_out))
                if kind == "head":
                    x = x * scale[name]
            out[name] = x
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "prior":
            out[name] = torch.full(shape, FOCAL_PRIOR_BIAS, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into the model's parameters; its buffers (the norms'
    running statistics) keep their construction values, 0 and 1."""
    with torch.no_grad():
        params = dict(model.named_parameters())
        missing = sorted(set(params) - set(weights))
        extra = sorted(set(weights) - set(params))
        if missing or extra:
            raise KeyError(f"weights: missing {missing[:5]}, extra "
                           f"{extra[:5]}")
        for name, p in params.items():
            p.copy_(weights[name])


def shapes_of(model: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    return sorted((n, tuple(p.shape)) for n, p in model.named_parameters())


def for_cell(model: torch.nn.Module, conf: dict, traffic: dict, seed: int,
             device) -> Dict[str, torch.Tensor]:
    """The weights of a cell's run for `model` (the program's or the
    reference's: the same names and shapes)."""
    return draw(shapes_of(model), seed, device, mode=traffic["weights"],
                head_scale=traffic.get("head_scale", 0.0),
                center_scale=traffic.get("center_head_scale"),
                use_focal=conf["model"]["cls_loss"].startswith("focal"))
