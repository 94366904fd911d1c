"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and nvcc and skip without them. This file
imports neither JAX nor the JAX package, so on a machine with a card and
no JAX it runs on its own, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

``chip_smoke.py`` runs the same comparisons at the main path's full shapes.
"""
import numpy as np
import pytest
import torch

from climsim_tpu_torch.online.advection import spherical_metric
from climsim_tpu_torch.ops import (bigru_heads_init_cm_reference,
                                   fused_bigru_heads_init_cm,
                                   fv_advect_tracers_sphere,
                                   fv_tracers_sphere_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _b1_inputs(L, H, B, dtype, device, seed=3):
    nf, nm_in, nm, ny = 6, 8, 8, 6
    rng = np.random.default_rng(seed)
    shapes = [(L, nf, B), (L, nm_in, B), (H, B), (H, B),
              (H, nf), (H, 1), (3 * H, H), (3 * H, nm_in), (3 * H, 1),
              (3 * H, H), (3 * H, 1), (3 * H, H), (3 * H, 1),
              (3 * H, H), (3 * H, 1), (nm, H), (nm, 1), (ny, nm), (ny, 1)]
    return [torch.as_tensor(0.25 * rng.standard_normal(s), dtype=dtype,
                            device=device) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 144])
def test_b1_kernel_matches_plain_f32(cuda, B):
    """f32, ragged B: summation order only (tolerance as the CPU parity
    tests of the plain version against JAX)."""
    a = _b1_inputs(20, 16, B, torch.float32, cuda)
    before = fused_bigru_heads_init_cm.launches
    with torch.no_grad():
        om, lh = fused_bigru_heads_init_cm(*a)
        ref_om, ref_lh = bigru_heads_init_cm_reference(*a)
    assert fused_bigru_heads_init_cm.launches == before + 1
    torch.testing.assert_close(om, ref_om, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(lh, ref_lh, rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
def test_b1_kernel_matches_plain_bf16(cuda):
    """bf16: both round at the same points; a one-ulp flip of an output
    of order 1 is 7.8e-3, so atol 2e-2 allows two."""
    a = _b1_inputs(20, 16, 144, torch.bfloat16, cuda)
    with torch.no_grad():
        om, lh = fused_bigru_heads_init_cm(*a)
        ref_om, ref_lh = bigru_heads_init_cm_reference(*a)
    torch.testing.assert_close(om.float(), ref_om.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lh.float(), ref_lh.float(), rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_b1_refuses_gradients(cuda):
    a = _b1_inputs(4, 16, 16, torch.float32, cuda)
    a[6].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="B3"):
        fused_bigru_heads_init_cm(*a)


@pytest.mark.cuda
def test_b2_kernel_matches_plain(cuda):
    """nvcc contracts a*b+c into FMAs, so the kernel and the plain version
    differ by a few ulps on fields of order 1; winds clip some Courant
    numbers."""
    rng = np.random.default_rng(5)
    nlat, nlon = 16, 24
    m = spherical_metric(np.linspace(-85.0, 85.0, nlat), nlon, 1200.0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    qs = t(rng.normal(1, 0.3, (3, 4, nlat, nlon)))
    u = t(rng.normal(0, 150, (4, nlat, nlon)))
    v = t(rng.normal(0, 700, (4, nlat, nlon)))
    before = fv_advect_tracers_sphere.launches
    with torch.no_grad():
        got = fv_advect_tracers_sphere(qs, u, v, m)
        ref = fv_tracers_sphere_reference(qs, u, v, m)
    assert fv_advect_tracers_sphere.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_b2_backward_matches_plain(cuda):
    """The kernel's autograd backward differentiates the plain version."""
    rng = np.random.default_rng(6)
    nlat, nlon = 16, 24
    m = spherical_metric(np.linspace(-85.0, 85.0, nlat), nlon, 1200.0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    qs, u, v = (t(rng.normal(1, 0.3, (2, 3, nlat, nlon))),
                t(rng.normal(0, 20, (3, nlat, nlon))),
                t(rng.normal(0, 20, (3, nlat, nlon))))
    q1 = qs.clone().requires_grad_(True)
    q2 = qs.clone().requires_grad_(True)
    fv_advect_tracers_sphere(q1, u, v, m).square().sum().backward()
    fv_tracers_sphere_reference(q2, u, v, m).square().sum().backward()
    torch.testing.assert_close(q1.grad, q2.grad, rtol=1e-4, atol=1e-5)
