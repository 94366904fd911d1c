"""TripleClouds and the radiation's other cloud optics in the port against
the JAX package, on the CPU, in float32: ``calc_overlap_matrices`` and
``adding_sw_tc`` (plain functions in both packages), the identity overlap
against the ICA solver, and ``RadiationModule`` with ``map_bands`` and
with ``learned_cloud_optics`` (grid-mean and McICA paths, with and without
the latent memory) on flax parameters carried across by
``from_flax_params``. The JAX side runs with 64-bit types off, as
tests/test_torch_phys_model.py explains.

Tolerances: the overlap matrices to 1e-6 (elementwise float32 with the
same operations); the solver's fluxes and the module's outputs to 1e-5
and ``RTOL`` (1e-4) of each output's scale (summation order through 60
levels of 2 x 2-region mixing; the module's gas-optics MLPs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models.phys_rad import RadiationModule as JaxRadiation
from climsim_tpu.physics import radiation as JR
from climsim_tpu_torch.models import RadiationModule, from_flax_params
from climsim_tpu_torch.physics import radiation as R
from torch_jit import jit_o0

RTOL = 1e-4
B, L, NREG = 5, 60, 4


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _overlap_inputs(seed=0):
    """Region fractions summing to 1 with some empty regions, and overlap
    parameters in [-0.5, 1] (the negative branch uses op0 itself)."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0, 1, (B, L, NREG))
    f[rng.uniform(0, 1, (B, L, NREG)) < 0.2] = 0.0
    f[..., 0] += 0.05
    f = (f / f.sum(-1, keepdims=True)).astype(np.float32)
    op = rng.uniform(-0.5, 1.0, (B, L - 1)).astype(np.float32)
    return f, op


def _solver_inputs(n, seed=1):
    """Two-stream layer properties in their physical ranges for n
    columns (g-points folded in) and NREG regions."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    tdir = u(0.3, 1.0, n, L, NREG)
    Rd = u(0.0, 0.3, n, L, NREG)
    Td = np.minimum(u(0.3, 1.0, n, L, NREG), 1 - Rd)
    rdir = u(0.0, 0.2, n, L, NREG) * (1 - tdir)
    tdd = u(0.0, 1.0, n, L, NREG) * (1 - tdir - rdir)
    return (u(100, 1300, n, NREG), u(0.05, 0.6, n, NREG),
            u(0.05, 0.6, n, NREG), Rd, Td, rdir, tdd, tdir)


def test_overlap_matrices_match_jax():
    f, op = _overlap_inputs()
    want = jit_o0(JR.calc_overlap_matrices, f, op)
    got = R.calc_overlap_matrices(torch.as_tensor(f), torch.as_tensor(op))
    assert tuple(got.shape) == (B, L + 1, NREG, NREG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # each column of v distributes the flux of one upper region: it sums
    # to 1 where that region has area
    fu = np.concatenate([np.eye(NREG)[None, :1].repeat(B, 0), f], 1)
    sums = got.sum(-2).numpy()
    np.testing.assert_allclose(sums[fu > 1e-6], 1.0, atol=1e-5)


def test_adding_sw_tc_matches_jax():
    f, op = _overlap_inputs(seed=2)
    V = np.asarray(jit_o0(JR.calc_overlap_matrices, f, op))
    args = _solver_inputs(B, seed=3) + (V,)
    want = jit_o0(JR.adding_sw_tc, *args)
    got = R.adding_sw_tc(*map(torch.as_tensor, args))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B, L + 1, NREG)
        assert _rel(g, w) <= 1e-5, _rel(g, w)


def test_identity_overlap_is_the_ica_solver():
    """With V = I the regions do not mix: adding_sw_tc is adding_sw on
    each region, as JAX's docstring states, wherever the direct-reflection
    terms agree (T_dir_dir = T: adding_sw_tc keeps the reference's
    T*albedodir*R, adding_sw the energy-conserving T_dir_dir*albedodir*R,
    in JAX as here); otherwise the direct fluxes and the albedos (the TOA
    upward flux) still agree, and the diffuse fluxes differ."""
    args = list(_solver_inputs(B, seed=4))
    eye = np.broadcast_to(np.eye(NREG, dtype=np.float32),
                          (B, L + 1, NREG, NREG)).copy()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    for same_term in (True, False):
        a = list(args)
        if same_term:
            a[7] = a[4].copy()                      # T_dir_dir = T
        tc = R.adding_sw_tc(*map(t, a), t(eye))
        ica = R.adding_sw(*[t(x) for x in a])
        jtc = jit_o0(JR.adding_sw_tc, *a, eye)
        jica = jit_o0(JR.adding_sw, *a)
        if same_term:
            for g, w in zip(tc, ica):
                assert _rel(g, w) <= 1e-6
            for g, w in zip(jtc, jica):
                assert _rel(g, w) <= 1e-6
        else:
            # the direct flux, and the TOA upward flux (the albedos')
            assert _rel(tc[2], ica[2]) <= 1e-6
            assert _rel(tc[0][:, 0], ica[0][:, 0]) <= 1e-6
            assert _rel(tc[1], ica[1]) > 1e-4
            assert _rel(jtc[1], jica[1]) > 1e-4
            assert _rel(tc[1], jtc[1]) <= 1e-5


def _module_inputs(seed=5, ng_sw=8, ng_lw=4, n_latent=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, lo=0.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    plev = np.sort(f(B, L + 1, lo=50.0, hi=1.0e5), 1)
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    tlay = f(B, L, lo=190.0, hi=310.0)
    gases = {"o3": np.full((B, L), 2e-6, np.float32),
             "ch4": np.full((B, L), 9.7e-7, np.float32),
             "n2o": np.full((B, L), 4.8e-7, np.float32),
             "h2o": f(B, L, hi=0.02)}
    clouds = {"lwp": f(B, L, hi=50.0), "iwp": f(B, L, hi=20.0),
              "lwp_sw_g": f(B, L, ng_sw, hi=50.0),
              "iwp_sw_g": f(B, L, ng_sw, hi=20.0),
              "lwp_lw_g": f(B, L, ng_lw, hi=50.0),
              "iwp_lw_g": f(B, L, ng_lw, hi=20.0),
              "landfrac": f(B), "icefrac": f(B), "snowh": f(B, hi=0.2)}
    if n_latent:
        clouds["latent"] = rng.normal(0, 1, (B, L, n_latent)).astype(
            np.float32)
    sfc = {"coszrs": f(B, lo=0.3), "solin": f(B, hi=1360.0),
           "lwup": f(B, lo=250.0, hi=500.0), "aldif": f(B), "aldir": f(B),
           "asdif": f(B), "asdir": f(B)}
    return tlay, play, plev, gases, clouds, sfc


MCICA = ("lwp_sw_g", "iwp_sw_g", "lwp_lw_g", "iwp_lw_g")


def _moved(name, a, rng):
    """A leaf moved by 5% of its scale (at least 0.05); the band map's
    bias only upward, since a negative one makes the cloud's optical
    depth negative where the path is thin (NaN in both packages)."""
    z = rng.standard_normal(a.shape).astype(np.float32)
    if name == "band_expand_bias":
        z = np.abs(z)
    return a + 0.05 * max(float(np.abs(a).max()), 1.0) * z


@pytest.mark.parametrize("opts,drop", [
    (dict(map_bands=True), MCICA),
    (dict(learned_cloud_optics=True), ()),
    (dict(learned_cloud_optics=True, n_latent=6), MCICA),
], ids=["map_bands", "learned_mcica", "learned_latent_grid_mean"])
def test_radiation_module_options_match_jax(opts, drop):
    """RadiationModule with the trainable band expansion (grid-mean paths:
    JAX takes McICA before it) and with learned cloud optics, on the
    port's init (flax's tree, as JAX's eval_shape of its init shows) with
    every leaf moved (``_moved``: the band map's kernel off the static
    repeat, some entries negative, the biases off zero)."""
    n_latent = opts.pop("n_latent", 0)
    tlay, play, plev, gases, clouds, sfc = _module_inputs(n_latent=n_latent)
    clouds = {k: v for k, v in clouds.items() if k not in drop}
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    rng = np.random.default_rng(6)
    # the port's init (flax's layout and JAX's constants) moved, as the
    # tree both packages take: JAX's eager init of the module is slow
    tr = RadiationModule(ng_lw=4, ng_sw=8, n_latent=n_latent, **opts,
                         generator=torch.Generator().manual_seed(2))
    tree = {}
    for name, v in tr.state_dict().items():
        node = tree
        for k in name.split(".")[:-1]:
            node = node.setdefault(k, {})
        node[name.split(".")[-1]] = _moved(name.split(".")[-1], v.numpy(),
                                           rng)
    tr.load_state_dict(from_flax_params(tree, tr))
    with jax.enable_x64(False):
        jr = JaxRadiation(ng_lw=4, ng_sw=8, **opts)
        args = (jnp.asarray(tlay), jnp.asarray(play), jnp.asarray(plev),
                j(gases), j(clouds), j(sfc))
        params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
        flat = jax.eval_shape(jr.init, jax.random.PRNGKey(0), *args)
        assert jax.tree_util.tree_structure(flat) \
            == jax.tree_util.tree_structure(params)
        jh, js = jit_o0(jr.apply, params, *args)
    with torch.no_grad():
        th, ts = tr(torch.as_tensor(tlay), torch.as_tensor(play),
                    torch.as_tensor(plev), t(gases), t(clouds), t(sfc))
    assert _rel(th, jh) <= RTOL, _rel(th, jh)
    for k in js:
        assert _rel(ts[k], js[k]) <= RTOL, (k, _rel(ts[k], js[k]))
    if opts.get("map_bands"):
        assert (tr.band_expand_kernel < 0).any()    # clamped at use
