"""The scene pool: the same seed gives the same inputs; another seed the
same rooms in another order."""

import numpy as np

from benchmark import scenes
from tiny import tiny_cell


def _pool():
    cell = tiny_cell("scannet_r34.train_b8")
    return scenes.scene_pool(cell["traffic"], cell["config"]["dataset_config"])


def test_same_seed_same_pool():
    a, b = _pool(), _pool()
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_seed_orders_the_same_rooms():
    o1 = scenes.batch_order(64, 8, 3000000123)
    o2 = scenes.batch_order(64, 8, 3000000123)
    o3 = scenes.batch_order(64, 8, 7)
    assert all((a == b).all() for a, b in zip(o1, o2))
    assert sorted(np.concatenate(o1)) == sorted(np.concatenate(o3)) \
        == list(range(64))
    assert any((a != b).any() for a, b in zip(o1, o3))


def test_rooms_keep_their_shapes():
    pool = _pool()
    for s in pool:
        assert s["point_clouds"].shape == (4000, 3)
        assert 3 <= s["gt_box_present"].sum() <= 10
