"""The port's `test_only` eval step against the JAX package's past 40000
points, where empty-box removal counts the points of a subsample: both
read JAX's index set, `jax.random.permutation(PRNGKey(0), N)[:40000]`,
handed to the port's trainer for this scan size. The port's own fixed
subsample (a seeded `torch.randperm`) is another subset, equally within
the reference's protocol (utils/ap_calculator.py:84), and stays the
default.

A file of its own, so that a worker other than the one running
`test_torch_eval.py` can take it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_eval import _assert_same_keep, _eval_steps
from test_torch_model import MODEL_ATOL, MODEL_RTOL, tiny_config
from vdetr_tpu.geometry.points_in_boxes import points_in_boxes_all
from vdetr_tpu_torch.geometry.points_in_boxes import points_in_boxes_count
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CLUSTERS, PER_CLUSTER = 288, 144  # 41472 points


def clustered_scene(seed=5):
    """One scene of CLUSTERS tight clusters (4 mm cubes) spread over
    1.2 x 1.2 x 0.6 m: past 40000 points, while the voxels (a few a
    cluster at 1 cm) fit the tiny config's capacity of 2048 and the
    points still fall into many of the predicted boxes."""
    rng = np.random.RandomState(seed)
    centres = rng.rand(CLUSTERS, 3) * [1.2, 1.2, 0.6]
    pts = centres[:, None] + rng.rand(CLUSTERS, PER_CLUSTER, 3) * 0.004
    pts = pts.reshape(1, -1, 3).astype(np.float32)
    return {"point_clouds": pts,
            "point_validity": np.ones(pts.shape[:2], bool),
            "point_cloud_dims_min": pts.min(1),
            "point_cloud_dims_max": pts.max(1)}


def subsample_counts(out, points, sel):
    """(JAX's, the port's) points of `points[:, sel]` in each predicted
    box (bottom-centred, as the eval steps build them)."""
    boxes = np.concatenate([out["center_unnormalized"],
                            out["size_unnormalized"],
                            out["angle_continuous"][..., None]], axis=-1)
    boxes[..., 2] -= boxes[..., 5] / 2
    pts = np.ascontiguousarray(points[:, sel])
    want = np.asarray(points_in_boxes_all(jnp.asarray(pts),
                                          jnp.asarray(boxes)).sum(1))
    got = points_in_boxes_count(torch.from_numpy(pts),
                                torch.from_numpy(boxes)).numpy()
    return want, got


def test_empty_box_removal_past_40000_points_matches_jax():
    """Outputs within the forward's tolerance, the keep masks equal (or
    apart only on rounding-level score ties, `_assert_same_keep`), and
    the removal does work here: it drops boxes and leaves more than one.
    The per-box counts on JAX's subset are equal in both, and they differ
    on the port's own subset: the index set matters to the counts."""
    inputs = clustered_scene()
    n = inputs["point_clouds"].shape[1]
    assert n > 40000
    sel = np.asarray(jax.random.permutation(jax.random.PRNGKey(0),
                                            n)[:40000])
    want, got, trainer = _eval_steps(tiny_config(test_only=True), inputs,
                                     subsample=sel)
    assert trainer.ap_config["remove_empty_box"]
    assert torch.equal(trainer._empty_box_subsample(n),
                       torch.from_numpy(sel).long())
    assert set(got) == set(want) and "nms_keep" in got
    for k, v in want.items():
        if k != "nms_keep":
            np.testing.assert_allclose(got[k], v, rtol=MODEL_RTOL,
                                       atol=MODEL_ATOL, err_msg=k)
    _assert_same_keep(got, want)

    out = {k: torch.from_numpy(v) for k, v in got.items()}
    nonempty = trainer._nonempty(out, torch.from_numpy(
        inputs["point_clouds"]))
    K = nonempty.shape[1]
    assert 1 < int(nonempty.sum()) < K  # drops boxes, keeps several
    kept = got["nms_keep"]
    assert kept.any() and not (kept & ~nonempty.numpy()).any()

    want_n, got_n = subsample_counts(got, inputs["point_clouds"], sel)
    np.testing.assert_array_equal(got_n, want_n)
    trainer._subsample.clear()
    own = trainer._empty_box_subsample(n).numpy()
    assert (subsample_counts(got, inputs["point_clouds"], own)[1]
            != got_n).any()
