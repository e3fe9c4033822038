"""The model configuration: `vdetr_tpu.config.VDETRConfig`, re-exported.

The dataclass is plain Python (no jax), shared with the JAX package so
both read one set of defaults: the published ScanNet recipe.
"""

from vdetr_tpu.config import VDETRConfig

__all__ = ["VDETRConfig"]
