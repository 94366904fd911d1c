"""The port's spherical multi-tracer FV stencil (plain PyTorch version of
the CUDA kernel) against the JAX package's Pallas kernel in interpret mode
and its jnp reference, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.online import advection as jadv
from climsim_tpu.ops.pallas_stencil import (_fv_sphere_fwd_impl,
                                            _fv_sphere_reference)
from climsim_tpu_torch.online import advection as tadv
from climsim_tpu_torch.ops.pallas_stencil import (fv_advect_tracers_sphere,
                                                  fv_tracers_sphere_reference)

NTRAC, NLEV, NLAT, NLON = 3, 4, 16, 24
DT = 1200.0


def _case(seed=5):
    """Inputs whose winds are strong enough that the Courant clip binds
    near the poles and in some meridional faces."""
    rng = np.random.default_rng(seed)
    lats = np.linspace(-85.0, 85.0, NLAT)
    qs = rng.normal(1, 0.3, (NTRAC, NLEV, NLAT, NLON)).astype(np.float32)
    u = rng.normal(0, 150, (NLEV, NLAT, NLON)).astype(np.float32)
    v = rng.normal(0, 700, (NLEV, NLAT, NLON)).astype(np.float32)
    jm = jadv.spherical_metric(lats, NLON, DT)
    tm = tadv.spherical_metric(lats, NLON, DT)
    return qs, u, v, jm, tm


def test_courant_clip_binds():
    qs, u, v, jm, _ = _case()
    cz = np.abs(u * jm.dtdx[None, :, None])
    vf = np.concatenate([v, v[:, -1:]], axis=1)
    cm = np.abs(vf * jm.cf_fac[None, :, None])
    assert (cz > jm.cfl_max).mean() > 0.01
    assert (cm > jm.cfl_max).mean() > 0.01


def test_plain_matches_pallas_interpret():
    """Same arithmetic in float32; ordering differences only (tolerance
    as test_advection_sphere.py's interpret test)."""
    qs, u, v, jm, tm = _case()
    got = fv_tracers_sphere_reference(torch.as_tensor(qs), torch.as_tensor(u),
                                      torch.as_tensor(v), tm)
    ref = np.asarray(_fv_sphere_fwd_impl(jnp.asarray(qs), jnp.asarray(u),
                                         jnp.asarray(v), jm, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=2e-6)


def test_plain_matches_jnp_reference():
    qs, u, v, jm, tm = _case()
    got = fv_tracers_sphere_reference(torch.as_tensor(qs), torch.as_tensor(u),
                                      torch.as_tensor(v), tm)
    ref = np.asarray(_fv_sphere_reference(jnp.asarray(qs), jnp.asarray(u),
                                          jnp.asarray(v), jm))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=2e-6)


def test_halo_path_matches_jax():
    """fv_advect_2d_sphere_halo on one latitude band with its 2 ghost rows
    each side, as a sharded step would call it."""
    qs, u, v, jm, tm = _case()
    ext = lambda a: np.concatenate([a[..., :1, :], a[..., :1, :], a,
                                    a[..., -1:, :], a[..., -1:, :]], axis=-2)
    q, uu, vv = ext(qs[0, 0]), ext(u[0]), ext(v[0])
    row0, n = 4, 8
    sl = slice(row0, row0 + n + 4)
    got = tadv.fv_advect_2d_sphere_halo(torch.as_tensor(q[sl]),
                                        torch.as_tensor(uu[sl]),
                                        torch.as_tensor(vv[sl]), tm, row0)
    ref = jadv.fv_advect_2d_sphere_halo(jnp.asarray(q[sl]), jnp.asarray(uu[sl]),
                                        jnp.asarray(vv[sl]), jm, row0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=2e-6)


def test_metric_matches_jax():
    _, _, _, jm, tm = _case()
    for k in ("dtdx", "dtdy", "cf_fac", "wf", "wc", "cosc", "cell_w"):
        a, b = getattr(tm, k), getattr(jm, k)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert tm.cfl_max == jm.cfl_max


def test_cpu_wrapper_takes_plain_path_and_differentiates():
    """A CPU tensor runs the plain version (no launch), and the op stays
    differentiable as the JAX custom_vjp is."""
    qs, u, v, _, tm = _case()
    q = torch.as_tensor(qs).requires_grad_(True)
    before = fv_advect_tracers_sphere.launches
    out = fv_advect_tracers_sphere(q, torch.as_tensor(u), torch.as_tensor(v),
                                   tm)
    assert fv_advect_tracers_sphere.launches == before == 0
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_conservation_in_solid_body_flow():
    """In a divergence-free (solid-body zonal) flow the advective-form
    step conserves the area integral sum(q * cell_w) to f32 rounding."""
    qs, _, _, _, tm = _case()
    w = torch.as_tensor(tm.cell_w)[:, None].double()
    ub = torch.full((NLEV, NLAT, NLON), 10.0)
    vb = torch.zeros((NLEV, NLAT, NLON))
    q = torch.as_tensor(qs)
    out = fv_tracers_sphere_reference(q, ub, vb, tm)
    tot0 = (q.double() * w).sum(dim=(-2, -1))
    tot1 = (out.double() * w).sum(dim=(-2, -1))
    torch.testing.assert_close(tot1, tot0, rtol=1e-6, atol=0)



@pytest.mark.parametrize("bad", ["dtype", "shape", "strides"])
def test_wrapper_rejects_what_the_kernel_would(bad):
    qs, u, v, _, tm = _case()
    qs, u, v = torch.as_tensor(qs), torch.as_tensor(u), torch.as_tensor(v)
    if bad == "dtype":
        qs = qs.double()
    elif bad == "shape":
        u = u[:, :-1]
    else:
        v = v.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fv_advect_tracers_sphere(qs, u, v, tm)
