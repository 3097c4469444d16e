"""The port's config is a field-for-field copy of the JAX package's."""

import dataclasses

import pytest

from eao_fusion_tpu import config as jcfg
from eao_fusion_tpu_torch import config as tcfg


def _dataclasses(mod):
    return {name: obj for name, obj in vars(mod).items()
            if dataclasses.is_dataclass(obj) and isinstance(obj, type)}


def test_same_dataclasses():
    assert set(_dataclasses(jcfg)) == set(_dataclasses(tcfg))


@pytest.mark.parametrize("name", sorted(_dataclasses(jcfg)))
def test_fields_and_defaults_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(j)]
    tf = [(f.name, str(f.type)) for f in dataclasses.fields(t)]
    assert jf == tf
    assert j.__dataclass_params__.frozen == t.__dataclass_params__.frozen
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())


def test_presets_and_constants_match():
    assert (dataclasses.asdict(jcfg.tum_fr3_config(use_planes=False))
            == dataclasses.asdict(tcfg.tum_fr3_config(use_planes=False)))
    assert (dataclasses.asdict(jcfg.d435i_config())
            == dataclasses.asdict(tcfg.d435i_config()))
    assert jcfg.COCO_CLASS_WHITELIST == tcfg.COCO_CLASS_WHITELIST
    c = tcfg.CameraConfig()
    assert c.baseline == jcfg.CameraConfig().baseline
    assert c.depth_threshold == jcfg.CameraConfig().depth_threshold
