"""The port's variable sets (``climsim_tpu_torch/variables.py``) against
the JAX package's: names, level/scalar splits, lengths, layout slices and
the index contracts, for every set; and the constants they need."""
import pytest

import climsim_tpu.constants as jconst
import climsim_tpu.variables as JV
import climsim_tpu_torch.constants as tconst
import climsim_tpu_torch.variables as TV


def _layout(fl):
    return dict(names=fl.names, lens=fl.lens, total=fl.total,
                slices=fl.slices, lev_names=fl.lev_names,
                sfc_names=fl.sfc_names, n_lev_vars=fl.n_lev_vars,
                n_sfc_vars=fl.n_sfc_vars,
                index={n: fl.index(n) for n in fl.names})


def test_registry_names_match_jax():
    assert list(TV.REGISTRY) == list(JV.REGISTRY) == \
        ["v1", "v2", "v2_rh", "v4", "v4_rnn", "v5"]


@pytest.mark.parametrize("name", list(JV.REGISTRY))
def test_variable_set_matches_jax(name):
    """Every field of the set and of its two layouts, and the flat index
    of state_ps the reference keys on."""
    t, j = TV.get(name), JV.get(name)
    assert (t.name, t.full_vars, t.full_vars_v5) == \
        (j.name, j.full_vars, j.full_vars_v5)
    assert _layout(t.inputs) == _layout(j.inputs)
    assert _layout(t.outputs) == _layout(j.outputs)
    assert (t.ps_index, t.input_feature_len, t.target_feature_len) == \
        (j.ps_index, j.input_feature_len, j.target_feature_len)
    for n in t.inputs.names + t.outputs.names:
        assert TV.var_len(n) == JV.var_len(n), n


def test_reference_index_contracts():
    """The reference's hard indices: state_ps at flat index 120 (v1), 360
    (v2), 1500 (v4) and 1380 (v5); SNOWHICE at 1515 in v4; 368 v2
    outputs."""
    assert [TV.get(v).ps_index for v in ("v1", "v2", "v4", "v5")] == \
        [120, 360, 1500, 1380]
    assert TV.get("v4").inputs.index("cam_in_SNOWHICE") == 1515
    assert TV.get("v2").target_feature_len == 368


def test_energy_conversions_and_constants_match_jax():
    assert TV.ENERGY_CONV == JV.ENERGY_CONV
    assert TV.NLEV == JV.NLEV
    for k in ("RHO_AIR", "RHO_H2O", "CP", "LV", "LF", "LSUB", "GRAV", "P0",
              "NLEV", "NCOL_LOWRES"):
        assert getattr(tconst, k) == getattr(jconst, k), k
