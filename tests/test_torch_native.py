"""The port's binding of the native host loader (``data/native.py``:
``native/libhostloader.so`` through ctypes) against the JAX package's
binding of the same library and against numpy, on the CPU: every
function on float32 arrays (equal to numpy's to float32 rounding; the
two bindings bit-equal), and the numpy path where the library is not
loaded, as ``available()`` says."""
import numpy as np
import pytest

from climsim_tpu.data import native as JN
from climsim_tpu_torch.data import native as TN

RNG = np.random.default_rng(0)
SRC = RNG.normal(5, 3, (40, 12, 3)).astype(np.float32)
IDX = RNG.integers(0, 40, 25)
MEAN = RNG.normal(0, 1, (12, 3)).astype(np.float32)
DIV = RNG.uniform(0.5, 2, (12, 3)).astype(np.float32)


def _cases(mod):
    x = SRC.copy()
    y = np.abs(SRC).copy()
    z = SRC.copy()
    z[3, 2, 1], z[7, 0, 0], z[9, 5, 2] = np.nan, np.inf, -np.inf
    return {"gather_normalize": mod.gather_normalize(SRC, IDX, MEAN, DIV),
            "gather": mod.gather(SRC, IDX),
            "normalize_inplace": mod.normalize_inplace(x, MEAN, DIV),
            "cloud_exp_inplace": mod.cloud_exp_inplace(
                y, np.linspace(1, 3, 12).astype(np.float32), 2),
            "scrub_nonfinite": mod.scrub_nonfinite(z)}


def _numpy():
    y = np.abs(SRC).copy()
    y[:, :, 2] = 1.0 - np.exp(-y[:, :, 2] * np.linspace(1, 3, 12))
    z = SRC.copy()
    z[3, 2, 1] = z[7, 0, 0] = z[9, 5, 2] = 0.0
    return {"gather_normalize": (SRC[IDX] - MEAN) / DIV,
            "gather": SRC[IDX], "normalize_inplace": (SRC - MEAN) / DIV,
            "cloud_exp_inplace": y, "scrub_nonfinite": z}


def test_available_and_threads():
    assert TN.available() == JN.available()
    assert TN.thread_count() >= 1
    if TN.available():
        assert TN.thread_count() == JN.thread_count()


def test_binding_matches_jax_and_numpy():
    got, want, ref = _cases(TN), _cases(JN), _numpy()
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_numpy_path_without_the_library(monkeypatch):
    """With no library (``_LIB`` False, as after a failed load and build)
    every function computes the same with numpy."""
    monkeypatch.setattr(TN, "_LIB", False)
    assert not TN.available() and TN.thread_count() == 1
    got, ref = _cases(TN), _numpy()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_inplace_refuses_a_copy():
    with pytest.raises(AssertionError):
        TN.normalize_inplace(SRC.astype(np.float64), MEAN, DIV)
