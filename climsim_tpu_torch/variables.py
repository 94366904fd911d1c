"""Variable registries and feature layouts for every ClimSim variable set.

A copy of ``climsim_tpu/variables.py`` (which imports no JAX), kept here
so the port imports nothing of the JAX package. Each set is a frozen
:class:`VariableSet` carrying input/output variable names in the
reference's order (climsim_utils/data_utils.py:178-477, :568-652);
:class:`FeatureLayout` derives flat-vector slices, the (level, scalar)
split of the keeplev data layout, and the hard index contracts the
reference keys on (ps flat index 120/360/1500/1380, SNOWHICE at 1515 for
v4, the 368-feature output ordering of online_testing/README.md §3.1).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

from . import constants as C

NLEV = C.NLEV

# per-variable feature length (data_utils.py:402-477); every name not listed
# here is a scalar (length 1).
_LEV_VARS = {
    "state_t", "state_rh", "state_q0001", "state_q0002", "state_q0003",
    "state_qn", "liq_partition", "state_u", "state_v",
    "state_t_dyn", "state_q0_dyn", "state_u_dyn", "state_v_dyn",
    "state_t_prvphy", "state_q0001_prvphy", "state_q0002_prvphy",
    "state_q0003_prvphy", "state_qn_prvphy", "state_u_prvphy",
    "tm_state_t_dyn", "tm_state_q0_dyn", "tm_state_u_dyn",
    "tm_state_t_prvphy", "tm_state_q0001_prvphy", "tm_state_q0002_prvphy",
    "tm_state_q0003_prvphy", "tm_state_qn_prvphy", "tm_state_u_prvphy",
    "pbuf_ozone", "pbuf_CH4", "pbuf_N2O",
    "ptend_t", "ptend_q0001", "ptend_q0002", "ptend_q0003", "ptend_qn",
    "ptend_u", "ptend_v",
}


def var_len(name: str) -> int:
    return NLEV if name in _LEV_VARS else 1


# energy-unit conversion to W/m^2 for metrics (data_utils.py:490-504)
ENERGY_CONV = {
    "ptend_t": C.CP,
    "ptend_q0001": C.LV,
    "ptend_q0002": C.LV,
    "ptend_q0003": C.LV,
    "ptend_qn": C.LV,
    "ptend_u": None,          # winds are excluded from energy-unit metrics
    "ptend_v": None,
    "cam_out_NETSW": 1.0,
    "cam_out_FLWDS": 1.0,
    "cam_out_PRECSC": C.LV * C.RHO_H2O,
    "cam_out_PRECC": C.LV * C.RHO_H2O,
    "cam_out_SOLS": 1.0,
    "cam_out_SOLL": 1.0,
    "cam_out_SOLSD": 1.0,
    "cam_out_SOLLD": 1.0,
}

# ---------------------------------------------------------------------------
# canonical variable orderings (exact reference order)
# ---------------------------------------------------------------------------

V1_INPUTS = ["state_t", "state_q0001", "state_ps", "pbuf_SOLIN",
             "pbuf_LHFLX", "pbuf_SHFLX"]
V1_OUTPUTS = ["ptend_t", "ptend_q0001", "cam_out_NETSW", "cam_out_FLWDS",
              "cam_out_PRECSC", "cam_out_PRECC", "cam_out_SOLS",
              "cam_out_SOLL", "cam_out_SOLSD", "cam_out_SOLLD"]

_SFC_COMMON = ["state_ps", "pbuf_SOLIN", "pbuf_LHFLX", "pbuf_SHFLX",
               "pbuf_TAUX", "pbuf_TAUY", "pbuf_COSZRS",
               "cam_in_ALDIF", "cam_in_ALDIR", "cam_in_ASDIF", "cam_in_ASDIR",
               "cam_in_LWUP", "cam_in_ICEFRAC", "cam_in_LANDFRAC",
               "cam_in_OCNFRAC", "cam_in_SNOWHICE", "cam_in_SNOWHLAND"]

V2_INPUTS = (["state_t", "state_q0001", "state_q0002", "state_q0003",
              "state_u", "state_v"] + _SFC_COMMON
             + ["pbuf_ozone", "pbuf_CH4", "pbuf_N2O"])

V2_RH_INPUTS = (["state_t", "state_rh", "state_q0002", "state_q0003",
                 "state_u", "state_v", "pbuf_ozone", "pbuf_CH4", "pbuf_N2O"]
                + _SFC_COMMON)

V2_OUTPUTS = ["ptend_t", "ptend_q0001", "ptend_q0002", "ptend_q0003",
              "ptend_u", "ptend_v", "cam_out_NETSW", "cam_out_FLWDS",
              "cam_out_PRECSC", "cam_out_PRECC", "cam_out_SOLS",
              "cam_out_SOLL", "cam_out_SOLSD", "cam_out_SOLLD"]

_V4_TAIL = ["tm_state_ps", "tm_pbuf_SOLIN", "tm_pbuf_LHFLX",
            "tm_pbuf_SHFLX", "tm_pbuf_COSZRS", "clat", "slat", "icol"]

V4_INPUTS = (["state_t", "state_rh", "state_q0002", "state_q0003",
              "state_u", "state_v",
              "state_t_dyn", "state_q0_dyn", "state_u_dyn",
              "tm_state_t_dyn", "tm_state_q0_dyn", "tm_state_u_dyn",
              "state_t_prvphy", "state_q0001_prvphy", "state_q0002_prvphy",
              "state_q0003_prvphy", "state_u_prvphy",
              "tm_state_t_prvphy", "tm_state_q0001_prvphy",
              "tm_state_q0002_prvphy", "tm_state_q0003_prvphy",
              "tm_state_u_prvphy",
              "pbuf_ozone", "pbuf_CH4", "pbuf_N2O"] + _SFC_COMMON + _V4_TAIL)

# v4_rnn = v4 minus the *_prvphy vars and icol (data_utils.py:303-306)
V4_RNN_INPUTS = [v for v in V4_INPUTS if "prvphy" not in v and v != "icol"]

V4_OUTPUTS = list(V2_OUTPUTS)

V5_INPUTS = (["state_t", "state_rh", "state_qn", "liq_partition",
              "state_u", "state_v",
              "state_t_dyn", "state_q0_dyn", "state_u_dyn",
              "tm_state_t_dyn", "tm_state_q0_dyn", "tm_state_u_dyn",
              "state_t_prvphy", "state_q0001_prvphy", "state_qn_prvphy",
              "state_u_prvphy",
              "tm_state_t_prvphy", "tm_state_q0001_prvphy",
              "tm_state_qn_prvphy", "tm_state_u_prvphy",
              "pbuf_ozone", "pbuf_CH4", "pbuf_N2O"] + _SFC_COMMON + _V4_TAIL)

V5_OUTPUTS = ["ptend_t", "ptend_q0001", "ptend_qn", "ptend_u", "ptend_v",
              "cam_out_NETSW", "cam_out_FLWDS", "cam_out_PRECSC",
              "cam_out_PRECC", "cam_out_SOLS", "cam_out_SOLL",
              "cam_out_SOLSD", "cam_out_SOLLD"]


@dataclass(frozen=True)
class FeatureLayout:
    """Flat-vector layout for an ordered variable list."""

    names: tuple[str, ...]

    @cached_property
    def lens(self) -> tuple[int, ...]:
        return tuple(var_len(n) for n in self.names)

    @cached_property
    def total(self) -> int:
        return sum(self.lens)

    @cached_property
    def slices(self) -> dict[str, slice]:
        out, off = {}, 0
        for n, ln in zip(self.names, self.lens):
            out[n] = slice(off, off + ln)
            off += ln
        return out

    def index(self, name: str) -> int:
        """Flat start index of a variable (for scalars: its index)."""
        return self.slices[name].start

    @cached_property
    def lev_names(self) -> tuple[str, ...]:
        return tuple(n for n in self.names if var_len(n) == NLEV)

    @cached_property
    def sfc_names(self) -> tuple[str, ...]:
        return tuple(n for n in self.names if var_len(n) == 1)

    @property
    def n_lev_vars(self) -> int:
        return len(self.lev_names)

    @property
    def n_sfc_vars(self) -> int:
        return len(self.sfc_names)


@dataclass(frozen=True)
class VariableSet:
    name: str
    inputs: FeatureLayout
    outputs: FeatureLayout
    full_vars: bool = False       # v2/v4-style 6-tendency outputs
    full_vars_v5: bool = False    # v5-style merged qn outputs

    @property
    def ps_index(self) -> int:
        return self.inputs.index("state_ps")

    @property
    def input_feature_len(self) -> int:
        return self.inputs.total

    @property
    def target_feature_len(self) -> int:
        return self.outputs.total


def _vs(name, inp, outp, **kw) -> VariableSet:
    return VariableSet(name, FeatureLayout(tuple(inp)), FeatureLayout(tuple(outp)), **kw)


V1 = _vs("v1", V1_INPUTS, V1_OUTPUTS)
V2 = _vs("v2", V2_INPUTS, V2_OUTPUTS, full_vars=True)
V2_RH = _vs("v2_rh", V2_RH_INPUTS, V2_OUTPUTS, full_vars=True)
V4 = _vs("v4", V4_INPUTS, V4_OUTPUTS, full_vars=True)
V4_RNN = _vs("v4_rnn", V4_RNN_INPUTS, V4_OUTPUTS, full_vars=True)
V5 = _vs("v5", V5_INPUTS, V5_OUTPUTS, full_vars_v5=True)

REGISTRY: dict[str, VariableSet] = {
    v.name: v for v in (V1, V2, V2_RH, V4, V4_RNN, V5)
}


def get(name: str) -> VariableSet:
    return REGISTRY[name]
