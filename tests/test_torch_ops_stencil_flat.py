"""The port's flat-raster FV stencils (the plain PyTorch version of the
CUDA kernel behind B5 ``fv_advect_tracers`` and B6 ``fv_advect_levels``)
against the JAX package's Pallas kernels in interpret mode and its jnp
reference, and their gradients against the JAX op's custom_vjp, on the
CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.pallas_stencil import (_fv_advect_tracers_fwd_impl,
                                            _fv_reference,
                                            fv_advect_levels as jlevels,
                                            fv_advect_tracers as jtracers)
from climsim_tpu_torch.ops import (fv_advect_levels, fv_advect_tracers,
                                   fv_tracers_reference)

NTRAC, NLEV, NLAT, NLON = 3, 4, 8, 12
DT_DX, DT_DY = 0.4, 0.3


def _case(seed=1):
    """Tracers of order 1 and winds with both signs whose Courant numbers
    reach ~1 (the flat stencil has no clip)."""
    rng = np.random.default_rng(seed)
    qs = np.abs(rng.normal(1, 0.3, (NTRAC, NLEV, NLAT, NLON)))
    u = rng.normal(0, 1.0, (NLEV, NLAT, NLON))
    v = rng.normal(0, 1.0, (NLEV, NLAT, NLON))
    return [a.astype(np.float32) for a in (qs, u, v)]


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def test_plain_matches_pallas_interpret_tracers():
    """B5's plain version against the multi-tracer Pallas program and the
    jnp reference: the same float32 arithmetic, to 1e-6."""
    a = _case()
    got = fv_tracers_reference(*_t(a), DT_DX, DT_DY).numpy()
    kern = np.asarray(_fv_advect_tracers_fwd_impl(*_j(a), DT_DX, DT_DY,
                                                  True))
    ref = np.asarray(_fv_reference(*_j(a), DT_DX, DT_DY))
    np.testing.assert_allclose(got, kern, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_plain_matches_pallas_interpret_levels():
    """B6 (one field per level) against the per-level Pallas program."""
    qs, u, v = _case(2)
    got = fv_advect_levels(*_t([qs[0], u, v]), DT_DX, DT_DY).numpy()
    kern = np.asarray(jlevels(*_j([qs[0], u, v]), DT_DX, DT_DY,
                              interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-6, atol=1e-6)


def test_constant_field_is_preserved():
    """The advective form keeps a constant field constant under
    compressible winds (the JAX suite's check)."""
    _, u, v = _case(3)
    q = torch.full((NLEV, NLAT, NLON), 0.7)
    out = fv_advect_levels(q, *_t([u, v]), DT_DX, DT_DY)
    torch.testing.assert_close(out, q, rtol=1e-6, atol=0)


@pytest.mark.parametrize("op", ["tracers", "levels"])
def test_gradient_matches_jax_custom_vjp(op):
    """The wrappers' gradients (autograd through the plain version on the
    CPU; on the card the kernel's backward differentiates the same plain
    version) against jax.grad of the JAX op, whose custom_vjp
    differentiates its jnp reference."""
    qs, u, v = _case(4)
    if op == "levels":
        qs = qs[0]
    t = [x.requires_grad_(True) for x in _t([qs, u, v])]
    fn = fv_advect_tracers if op == "tracers" else fv_advect_levels
    (fn(*t, DT_DX, DT_DY) ** 2).sum().backward()
    if op == "tracers":
        jfn = lambda a, b, c: jtracers(a, b, c, DT_DX, DT_DY)
    else:       # the per-level Pallas op has no VJP: its jnp reference
        jfn = lambda a, b, c: _fv_reference(a[None], b, c, DT_DX,
                                            DT_DY)[0]
    want = jax.grad(lambda a, b, c: jnp.sum(jfn(a, b, c) ** 2),
                    argnums=(0, 1, 2))(*_j([qs, u, v]))
    for g, w, name in zip(t, want, ("q", "u", "v")):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_cpu_wrappers_take_plain_path():
    """A CPU tensor runs the plain version and launches nothing."""
    qs, u, v = _t(_case())
    b5, b6 = fv_advect_tracers.launches, fv_advect_levels.launches
    torch.testing.assert_close(fv_advect_tracers(qs, u, v, DT_DX, DT_DY),
                               fv_tracers_reference(qs, u, v, DT_DX, DT_DY),
                               rtol=0, atol=0)
    torch.testing.assert_close(fv_advect_levels(qs[1], u, v, DT_DX, DT_DY),
                               fv_tracers_reference(qs, u, v, DT_DX,
                                                    DT_DY)[1],
                               rtol=0, atol=0)
    assert (fv_advect_tracers.launches, fv_advect_levels.launches) \
        == (b5, b6) == (0, 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides", "rank"])
def test_wrappers_reject_what_the_kernel_would(bad):
    qs, u, v = _t(_case())
    if bad == "dtype":
        qs = qs.double()
    elif bad == "shape":
        u = u[:, :-1]
    elif bad == "strides":
        v = v.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        if bad == "rank":
            fv_advect_levels(qs, u, v, DT_DX, DT_DY)
        else:
            fv_advect_tracers(qs, u, v, DT_DX, DT_DY)
