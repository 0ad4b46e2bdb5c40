"""The port's EnvConfig against the JAX package's: field names, defaults,
derived properties and validation errors equal (exact)."""

import dataclasses
import enum

import jax.numpy as jnp
import pytest
import torch

from adcraft_tpu import config as jconfig
from adcraft_tpu_torch import config as tconfig


def plain(value):
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    return value


@pytest.mark.parametrize("cls", ["EnvConfig", "UpdaterConfig"])
def test_fields_and_defaults(cls):
    j, t = getattr(jconfig, cls)(), getattr(tconfig, cls)()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        assert plain(getattr(t, f.name)) == plain(getattr(j, f.name)), f.name


@pytest.mark.parametrize("name", ["KeywordKind", "CostModel", "CompetitorModel"])
def test_enums(name):
    assert [(m.name, m.value) for m in getattr(tconfig, name)] == [
        (m.name, m.value) for m in getattr(jconfig, name)
    ]


SHAPES = [
    {},
    {"max_volume": 576},
    {"max_volume": 96, "timesteps_per_day": 6},
    {"max_volume": 10, "timesteps_per_day": 24},
    {"max_volume": 1, "timesteps_per_day": 1},
    {"kind": "implicit"},
    {"kind": "implicit", "competitor_model": "binomial_pool"},
    {"cost_model": "python"},
]


def build(module, kw):
    kw = dict(kw)
    if "kind" in kw:
        kw["kind"] = module.KeywordKind(kw["kind"])
    if "competitor_model" in kw:
        kw["competitor_model"] = module.CompetitorModel(kw["competitor_model"])
    if "cost_model" in kw:
        kw["cost_model"] = module.CostModel(kw["cost_model"])
    return module.EnvConfig(**kw)


@pytest.mark.parametrize("kw", SHAPES, ids=str)
def test_derived_properties(kw):
    j, t = build(jconfig, kw), build(tconfig, kw)
    for prop in ("max_auctions_per_cell", "max_clicks_per_cell", "max_clicks_rest", "cents_costs"):
        assert getattr(t, prop) == getattr(j, prop), prop


def test_money_dtype_and_replace():
    assert tconfig.EnvConfig().money_dtype is torch.float32
    assert tconfig.EnvConfig(use_x64=True).money_dtype is torch.float64
    assert jconfig.EnvConfig().money_dtype is jnp.float32
    t = tconfig.EnvConfig().replace(num_keywords=7, day_kernel="pallas")
    assert (t.num_keywords, t.day_kernel) == (7, "pallas")
    assert hash(t) == hash(tconfig.EnvConfig(num_keywords=7, day_kernel="pallas"))


BAD = [
    {"num_keywords": 0},
    {"timesteps_per_day": 0},
    {"max_volume": 0},
    {"conv_sampling": "x"},
    {"rev_sampling": "x"},
    {"cost_sampling": "x"},
    {"agg_cost_grid": 1},
    {"agg_lite_lanes": 0},
    {"gate_scope": "x"},
    {"gate_scope": "chunk"},
    {"gate_chunk_t": 0},
    {"gate_compact": "x"},
    {"gate_compact_phase_a": -1},
    {"gate_compact_cap": -1},
    {"gate_scan_unroll": 0},
    {"lane_bits": 8},
    {"agg_draw_bits": 8},
    {"max_bidders_bound": 0},
    {"binomial_sampler": "x"},
]


@pytest.mark.parametrize("kw", BAD, ids=str)
def test_validation_errors(kw):
    with pytest.raises(ValueError) as jerr:
        jconfig.EnvConfig(**kw)
    with pytest.raises(ValueError) as terr:
        tconfig.EnvConfig(**kw)
    assert str(terr.value) == str(jerr.value)
