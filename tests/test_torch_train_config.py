"""The port's own `VDETRConfig` against the JAX package's: the same fields
with the same defaults, the same derived properties and capacities, and
the same validation. The port keeps a copy so that it imports nothing of
`vdetr_tpu`; this test is what keeps the copy true."""

import dataclasses

import pytest

from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu_torch.config import VDETRConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_fields_and_defaults_equal():
    jf = {f.name: (f.type, f.default) for f in dataclasses.fields(JaxConfig)}
    pf = {f.name: (f.type, f.default) for f in dataclasses.fields(VDETRConfig)}
    assert list(pf) == list(jf)
    assert pf == jf


@pytest.mark.parametrize("kw", [
    {}, dict(matcher_impl="jv"),
    dict(voxel_capacity=2048, min_stage_capacity=128, num_points=512),
    dict(cls_loss="focalloss_0.5", rpe_quant="bilinear_2_6"),
])
def test_properties_and_capacities_equal(kw):
    j, p = JaxConfig(**kw), VDETRConfig(**kw)
    props = [n for n, v in vars(JaxConfig).items() if isinstance(v, property)]
    assert props
    for name in props:
        assert getattr(p, name) == getattr(j, name), name
    assert p.stage_capacities() == j.stage_capacities()
    assert dataclasses.asdict(p.replace(seed=3)) == \
        dataclasses.asdict(j.replace(seed=3))


@pytest.mark.parametrize("kw", [
    dict(matcher_impl="hungry"), dict(rpe_impl="bogus"), dict(nsemcls=5),
    dict(mlp_sep=False), dict(minkowski=False),
    dict(compute_dtype="float16"), dict(matcher_impl="jv"),
])
def test_validate_refuses_what_the_jax_config_refuses(kw):
    def outcome(cls):
        try:
            cls(**kw).validate()
        except Exception as e:  # noqa: BLE001 - compared across packages
            return type(e)
        return None

    assert outcome(VDETRConfig) == outcome(JaxConfig)
    assert (outcome(JaxConfig) is None) == (kw == dict(matcher_impl="jv"))
