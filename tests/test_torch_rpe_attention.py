"""The port's vertex-RPE cross-attention against the JAX package.

On the CPU the port's wrapper takes its plain version, which is held to
`rpe_cross_attention_reference` and to the Pallas kernel run in
interpret mode, with rotation on and off, masked keys, a fully masked
batch row and several key tiles. The Hopper kernel itself is held to the
plain version by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetr_tpu.ops.rpe_attention import (rpe_cross_attention_pallas,
                                         rpe_cross_attention_reference)
from vdetr_tpu_torch.ops.rpe_attention import rpe_cross_attention

KW = dict(log_scale=512.0, max_value=4.0)
# the JAX package's own tolerance for its kernel against the reference
ATOL, RTOL = 2e-5, 2e-4


def make_case(rng, B=2, nQ=16, nK=64, H=4, hd=8, n=10):
    """Decoder-like inputs; corners i and i+4 share x/y, as every
    box-derived corner set does and the Pallas kernel requires."""
    q = rng.randn(B, nQ, H, hd).astype(np.float32) * 0.3
    k = rng.randn(B, nK, hd).astype(np.float32) * 0.3
    v = rng.randn(B, nK, hd).astype(np.float32)
    centers = rng.rand(B, nQ, 3).astype(np.float32) * 4
    sizes = rng.rand(B, nQ, 3).astype(np.float32) + 0.3
    offs = np.array([[i, j, l] for l in (-1, 1) for i in (-1, 1)
                     for j in (-1, 1)], np.float32) / 2
    corners = centers[:, :, None, :] + offs[None, None] * sizes[:, :, None, :]
    angles = (rng.rand(B, nQ).astype(np.float32) - 0.5) * 2
    key_xyz = rng.rand(B, nK, 3).astype(np.float32) * 4
    tables = rng.randn(8, n, n, n, H).astype(np.float32) * 0.1
    key_valid = rng.rand(B, nK) > 0.2
    key_valid[-1] = False  # one batch row with every key masked
    return [q, k, v, corners.astype(np.float32), angles, key_xyz, tables,
            key_valid]


def port(case, **kw):
    return rpe_cross_attention(*map(torch.from_numpy, case), **KW,
                               **kw).numpy()


@pytest.mark.parametrize("rotate", [False, True])
def test_plain_matches_reference(rng, rotate):
    case = make_case(rng)
    ref = rpe_cross_attention_reference(*map(jnp.asarray, case), **KW,
                                        rotate=rotate)
    np.testing.assert_allclose(port(case, rotate=rotate), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rotate,tk", [(False, None), (True, None),
                                       (False, 32)])
def test_plain_matches_pallas_interpret(rng, rotate, tk):
    case = make_case(rng, nK=96 if tk else 64)
    ref = rpe_cross_attention_pallas(*map(jnp.asarray, case), **KW,
                                     rotate=rotate, tq=8, tk=tk,
                                     interpret=True)
    np.testing.assert_allclose(port(case, rotate=rotate), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_fully_masked_row_averages_values(rng):
    """A batch row whose keys are all masked attends uniformly, as the
    reference's where(valid, logits, -1e9) softmax does."""
    case = make_case(rng)
    got = port(case)
    want = np.broadcast_to(case[2][-1].mean(0), got[-1].shape)
    np.testing.assert_allclose(got[-1], want, atol=1e-6)


def test_no_mask_equals_all_valid(rng):
    case = make_case(rng)
    case[7] = np.ones_like(case[7])
    args = [torch.from_numpy(a) for a in case]
    np.testing.assert_array_equal(
        rpe_cross_attention(*args[:7], None, **KW).numpy(),
        rpe_cross_attention(*args, **KW).numpy())

