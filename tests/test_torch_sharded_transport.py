"""The port's latitude-sharded coupled step on 2 and 4 gloo ranks against
the JAX package's sharded and single-device steps (as
tests/test_torch_sharded_step.py, which holds the production step) in the
other transports: vertical advection on the sphere and on the flat raster,
and semi-Lagrangian transport on both, whose departures never leave the
halo."""
import jax.numpy as jnp
import pytest
import torch

from climsim_tpu.online import advection as jadv
from climsim_tpu_torch import Grid
from climsim_tpu_torch.online import HostLoopConfig, HybridLoop
from climsim_tpu_torch.online import advection as tadv

import torch_dist_workers as W
import torch_sharded_jax as S

CASES = ("vertical_sphere", "vertical_flat", "sl_sphere", "sl_flat")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return S.sharded_runs(tmp_path_factory, CASES)


@pytest.mark.parametrize("ranks", S.RANKS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_jax(runs, case, ranks):
    """energy_int at rtol 1e-5: in these configurations JAX's own sharded
    step and its single-device step differ by up to 1.8e-6 (the energy
    fixer's uniform shift of T, a quotient of cancelling f32 integrals)."""
    S.assert_case(runs, case, ranks, energy_rtol=1e-5)


@pytest.mark.parametrize("case", ["sl_sphere", "sl_flat"])
def test_semi_lagrangian_cases_stay_inside_the_halo(runs, case):
    """The semi-Lagrangian cases are certified: no meridional departure of
    the initial winds leaves the 2-row halo (the port's clip fraction and
    JAX's are 0)."""
    _, _, state = runs
    cfg = HostLoopConfig(**W.SHARDED_CASES[case][0])
    loop = HybridLoop(None, Grid.synthetic(S.NCOL, S.NLEV), cfg, device="cpu")
    v = state["v"][loop.gather_idx.numpy()].reshape(W.NLAT, W.NLON, S.NLEV)
    dt_dy = (cfg.dt_dy if loop.metric is None
             else loop.metric.dtdy[:, None, None])
    assert float(tadv.semi_lagrangian_halo_clip_fraction(
        torch.as_tensor(v), torch.as_tensor(dt_dy))) == 0.0
    assert float(jadv.semi_lagrangian_halo_clip_fraction(
        jnp.asarray(v), jnp.asarray(dt_dy, jnp.float32))) == 0.0
