"""The port's latitude-sharded coupled step (``online/host_loop.py::
sharded_hybrid_step``) on 2 and 4 gloo ranks on the CPU, against the JAX
package's ``sharded_hybrid_step`` on a 2- and a 4-device mesh and against
JAX's single-device ``coupled_step``, with the real scan-arm emulator of
tests/test_online.py:135-159 (nneur 16, nh_mem 4) on the same flax
weights, on ``Grid.synthetic(384)`` (16 x 24 bands, 60 levels): the
production step (sphere FV, both fixers) with and without the overlap,
and no transport (tests/test_torch_sharded_transport.py holds the other
transports); the ValueErrors of the contracts and row counts the step
refuses; and ``semi_lagrangian_2d_halo`` over 4 hand-cut bands against
JAX's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.online import advection as jadv
from climsim_tpu.online.host_loop import HostLoopConfig as JaxConfig
from climsim_tpu_torch.online import advection as tadv

import torch_sharded_jax as S

CASES = ("production_overlap", "production_exchange", "no_transport")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return S.sharded_runs(tmp_path_factory, CASES, errors=True)


@pytest.mark.parametrize("ranks", S.RANKS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_jax(runs, case, ranks):
    """energy_int at rtol 1e-6, JAX's bound for the production step
    (tests/test_online.py:449-463)."""
    S.assert_case(runs, case, ranks, energy_rtol=1e-6)


@pytest.mark.parametrize("ranks", S.RANKS)
def test_refused_contracts_and_row_counts(runs, ranks):
    """The step raises a ValueError for the channel-major contract, a
    feature builder, rows that do not divide over the ranks and fewer rows
    a rank than the halo, on every rank."""
    _, port, _ = runs
    for errors in port[ranks]["errors"]:
        assert "batch-major" in errors["level_major"]
        assert "feature_builder" in errors["feature_builder"]
        assert "does not divide" in errors["rows_undivided"]
        assert "fewer than the halo" in errors["rows_below_halo"]


@pytest.mark.parametrize("geometry", ["sphere", "flat"])
def test_semi_lagrangian_halo_bands_match_jax(geometry):
    """semi_lagrangian_2d_halo on 4 hand-cut bands with ghost rows from
    the clamped global grid (as tests/test_advection_sphere.py:205 cuts
    them for the FV step) against JAX's on the same bands, and equal to
    the single-device semi_lagrangian_2d (no departure leaves the halo)."""
    nlat, nlon, nsh, halo = 32, 48, 4, 2
    rng = np.random.default_rng(11)
    q = rng.normal(1, 0.2, (nlat, nlon)).astype(np.float32)
    u = rng.normal(0, 15, (nlat, nlon)).astype(np.float32)
    v = rng.normal(0, 8, (nlat, nlon)).astype(np.float32)
    if geometry == "sphere":
        m = jadv.spherical_metric(np.linspace(-88, 88, nlat), nlon,
                                  JaxConfig().dt)
        dtdx, dtdy = m.dtdx, m.dtdy
    else:
        dtdx = dtdy = np.full(nlat, 0.02, np.float32)
    assert np.abs(v * dtdy[:, None]).max() <= halo - 1
    ext = lambda a: np.concatenate([a[:1].repeat(halo, 0), a,
                                    a[-1:].repeat(halo, 0)])
    qe, ue, ve = ext(q), ext(u), ext(v)
    dxe, dye = ext(dtdx[:, None]), ext(dtdy[:, None])
    loc = nlat // nsh
    got, want = [], []
    for s in range(nsh):
        row0 = s * loc
        sl = slice(row0, row0 + loc + 2 * halo)
        args = (qe[sl], ue[sl], ve[sl], dxe[sl], dye[sl])
        got.append(tadv.semi_lagrangian_2d_halo(
            *map(torch.as_tensor, args), row0, nlat).numpy())
        want.append(np.asarray(jadv.semi_lagrangian_2d_halo(
            *map(jnp.asarray, args), row0, nlat)))
    got, want = np.concatenate(got), np.concatenate(want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    single = tadv.semi_lagrangian_2d(*map(torch.as_tensor, (q, u, v)),
                                     torch.as_tensor(dtdx[:, None]),
                                     torch.as_tensor(dtdy[:, None]))
    np.testing.assert_array_equal(got, single.numpy())
