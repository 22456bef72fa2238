"""The port's model configs against the JAX package's: every ``--arch``
id's ``CONFIG`` and ``REDUCED`` field by field, the analytic parameter
counts and the (arch x shape) cells.  Pure data, so equal exactly."""

import dataclasses

import pytest

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro_torch.configs import base, registry


def test_arch_ids_equal():
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert len(registry.ARCH_IDS) == 10


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_reference(arch, reduced):
    ref = ref_registry.get_config(arch, reduced=reduced)
    port = registry.get_config(arch, reduced=reduced)
    assert type(port).__name__ == type(ref).__name__
    assert type(port).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [c.shape_id for c in base.shapes_for(port)] == \
        [c.shape_id for c in ref_base.shapes_for(ref)]
    for p, r in zip(base.shapes_for(port), ref_base.shapes_for(ref)):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
    if isinstance(ref, ref_base.LMConfig):
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()
        assert port.is_gqa == ref.is_gqa


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_get_both(arch):
    full, red = registry.get_both(arch)
    assert full == registry.get_config(arch)
    assert red == registry.get_config(arch, reduced=True)


def test_shapes_for_rejects_other_configs():
    with pytest.raises(TypeError):
        base.shapes_for(base.ANNSConfig(name="x", n_vectors=1, dim=1))
