"""Weight bridge between the JAX package and the port.

The port's parameters are named after the reference V-DETR state_dict,
so `vdetr_tpu.train.torch_import.build_reference_state_dict` does all
the renaming from a flax tree, and `convert_torch_state_dict` the way
back. The one difference is the order of sparse-conv kernel offsets: the
reference layout (MinkowskiEngine) is x-fastest, the JAX package and the
port are z-fastest, so `k_port = k_ref[perm]` with torch_import's
`KERNEL_OFFSET_PERMUTATION`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from vdetr_tpu.config import VDETRConfig
from vdetr_tpu.train.torch_import import (KERNEL_OFFSET_PERMUTATION,
                                          build_reference_state_dict)


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
    and the input `convert_torch_state_dict` expects."""
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
