"""The port's model configurations (``repro_torch.configs``,
``repro_torch.models.config``) against the JAX package's: the arch ids and
aliases, every published config and its smoke reduction field for field,
and the parameter counts the roofline prices."""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.models import config as jmodel_config
from repro_torch import configs as tconfigs
from repro_torch.models import config as tmodel_config


def test_arch_ids_and_aliases_equal():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert len(tconfigs.ARCH_IDS) == 10


def test_model_config_fields_and_defaults_equal():
    tf = [(f.name, f.default) for f in
          dataclasses.fields(tmodel_config.ModelConfig)]
    jf = [(f.name, f.default) for f in
          dataclasses.fields(jmodel_config.ModelConfig)]
    assert tf == jf
    assert dataclasses.asdict(tmodel_config.ModelConfig()) == \
        dataclasses.asdict(jmodel_config.ModelConfig())


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equal(arch):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert type(t) is tmodel_config.ModelConfig
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert (t.q_dim, t.kv_dim, t.attention_free) == \
        (j.q_dim, j.kv_dim, j.attention_free)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_smoke_reduction_equal(arch):
    t = tconfigs.reduce_for_smoke(tconfigs.get_config(arch))
    j = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()


@pytest.mark.parametrize("alias", sorted(jconfigs.ALIASES))
def test_aliases_resolve_to_the_same_config(alias):
    assert dataclasses.asdict(tconfigs.get_config(alias)) == \
        dataclasses.asdict(jconfigs.get_config(alias))


def test_unknown_arch_raises():
    with pytest.raises(ModuleNotFoundError):
        tconfigs.get_config("not-an-arch")
