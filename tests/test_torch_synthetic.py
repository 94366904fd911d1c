"""The port's synthetic state generator (``data/synthetic.py::
generate_state``) against the JAX package's on the CPU. Fed JAX's own
draws (the normals of each split key), it must reproduce JAX's arithmetic.
JAX runs with x64 off, as the CLI runs it: with the suite's x64 on, its
untyped ``jnp.linspace`` lifts qc, qi and ozone to float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.data import synthetic as JS
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu_torch import Grid
from climsim_tpu_torch.data import synthetic as TS
from climsim_tpu_torch.physics import thermo

NCOL, NLEV = 384, 60


def _jax_draws(key):
    """The port's draw function giving JAX's normals: key i is keys[i] of
    the 32-way split, (i, j) the j-th sub-key _profile splits from
    keys[i]."""
    keys = jax.random.split(key, 32)
    seen = []

    def draw(k, shape):
        seen.append(k)
        kk = keys[k] if isinstance(k, int) else \
            jax.random.split(keys[k[0]])[k[1]]
        return torch.tensor(np.asarray(jax.random.normal(kk, shape,
                                                         jnp.float32)))
    return draw, seen


def _both(vset):
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(0)
        want = JS.generate_state(key, JS.SyntheticConfig(vset_name=vset),
                                 JaxGrid.synthetic(NCOL, NLEV))
        want = {k: np.asarray(v) for k, v in want.items()}
        draw, seen = _jax_draws(key)
        got = TS.generate_state(None, TS.SyntheticConfig(vset_name=vset),
                                Grid.synthetic(NCOL, NLEV), draw=draw)
    return got, want, seen


@pytest.mark.parametrize("vset", ["v1", "v4"])
def test_generate_state_matches_jax(vset):
    """v1 (the CLI's) and v4 (whose dynamics and previous-step inputs go
    through the fill rule, hash factor and reused key 21 included): the
    same keys, dtypes and shapes, every key within rtol 1e-6 of its
    field's scale (XLA's and torch's cos and pow differ by an ulp, and
    sums such as u = 20 sin(2 lat) + 5 n cancel). Relative humidity and
    the liquid fraction magnify T's ulp (the ramp (T - 253.16) / 20 near
    its foot), so they are held instead to the port's thermo, which
    equals JAX's bit for bit on JAX's own T, q and p."""
    got, want, seen = _both(vset)
    assert list(got) == list(want)
    for k in want:
        g = got[k].numpy()
        assert g.dtype == want[k].dtype == np.float32 and \
            g.shape == want[k].shape, k
        if k in ("state_rh", "liq_partition"):
            continue
        np.testing.assert_allclose(g, want[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[k]).max(),
                                   err_msg=k)
    pmid = Grid.synthetic(NCOL, NLEV).mid_pressure(got["state_ps"])
    assert torch.equal(got["state_rh"], thermo.specific_to_relative_humidity(
        got["state_q0001"], got["state_t"], pmid))
    assert torch.equal(got["liq_partition"],
                       thermo.liquid_fraction(got["state_t"]))
    with jax.enable_x64(False):
        jp = np.asarray(JaxGrid.synthetic(NCOL, NLEV).mid_pressure(
            jnp.asarray(want["state_ps"])))
    t = lambda k: torch.tensor(want[k])
    np.testing.assert_array_equal(thermo.specific_to_relative_humidity(
        t("state_q0001"), t("state_t"), torch.tensor(jp)).numpy(),
        want["state_rh"])
    np.testing.assert_array_equal(thermo.liquid_fraction(
        t("state_t")).numpy(), want["liq_partition"])
    # each key drawn once, _profile's two sub-keys of keys[0] included
    assert len(seen) == len(set(seen))
    assert set(seen) == {(0, 0), (0, 1), *range(1, 21)} | (
        {21} if vset == "v4" else set())


def test_generate_state_seeded_generator():
    """With a torch.Generator: the same seed twice gives the same bits,
    another seed other numbers; the land and ocean fractions share their
    noise, as JAX's keys[17]."""
    cfg, grid = TS.SyntheticConfig(vset_name="v4"), Grid.synthetic(NCOL,
                                                                   NLEV)
    a = TS.generate_state(torch.Generator().manual_seed(3), cfg, grid)
    b = TS.generate_state(torch.Generator().manual_seed(3), cfg, grid)
    c = TS.generate_state(torch.Generator().manual_seed(4), cfg, grid)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["state_t"], c["state_t"])
    land, ocean = a["cam_in_LANDFRAC"], a["cam_in_OCNFRAC"]
    inside = (land > 0) & (land < 1) & (ocean > 0) & (ocean < 1)
    assert inside.any()
    torch.testing.assert_close((land - 0.3)[inside], -(ocean - 0.7)[inside])
