"""Every configuration of the port equals the reference's field for field
(the dtype compared by name: a torch dtype against a JAX one), at the
published size and at the smoke size, and the registry holds the
reference's ten architectures."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402


def test_registry_holds_the_ported_archs():
    """All ten of the reference's architectures, and an unknown name
    still raises."""
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    assert len(tconfigs.ARCHS) == 10
    with pytest.raises(KeyError):
        tconfigs.get_config("granite-moe-3b-a800m-typo")


@pytest.mark.parametrize("size", ["config", "smoke"])
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_config_equals_reference(arch, size):
    get = {"config": (jconfigs.get_config, tconfigs.get_config),
           "smoke": (jconfigs.get_smoke_config,
                     tconfigs.get_smoke_config)}[size]
    j, t = get[0](arch), get[1](arch)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd.keys() == td.keys()
    assert np.dtype(jd.pop("dtype")).name == \
        str(td.pop("dtype")).split(".")[-1]
    assert jd == td
    for prop in ("layer_specs", "full_units", "tail_specs", "attn_layers"):
        assert getattr(j, prop) == getattr(t, prop), prop
    assert j.param_count() == t.param_count()
