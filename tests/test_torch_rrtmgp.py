"""The port's RRTMGP-NN gas optics (``models/rrtmgp.py``) against the JAX
package's, on the CPU: files fabricated by JAX's
``write_gas_optics_weights`` (the real weight files are not in the
repository) are read by both packages' schema readers and loaded as
modules, native and reduced (``reduce_to``: the fresh head carried
across by ``from_flax_params``), and give the same optical depths and
Planck fractions to 1e-5 of their scale (float32, the same MLP); the
port's own writer writes the same file; the band helpers give the same
numbers; the reduced checkpoint loader reads a torch checkpoint of the
reference's layout; ``reduced_retrain_tx`` trains the head alone; and the
entry points default to the card, raising without one."""
import jax
import numpy as np
import pytest
import torch

from climsim_tpu.models import rrtmgp as J
from climsim_tpu_torch.models import from_flax_params
from climsim_tpu_torch.models import rrtmgp as T
from torch_jit import jit_o0

RTOL = 1e-5


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _inputs(nx, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (4, 9, nx)).astype(np.float32),
            rng.uniform(50, 150, (4, 9)).astype(np.float32))


@pytest.mark.parametrize("lw,reduce_to", [(False, None), (True, None),
                                          (False, 16), (True, 16)],
                         ids=["sw", "lw", "sw_reduced", "lw_reduced"])
def test_loaded_module_matches_jax(tmp_path, lw, reduce_to):
    path = str(tmp_path / "w.nc")
    J.write_gas_optics_weights(path, nx=8 if lw else 7, nh=24,
                               ng=32 if lw else 28, lw=lw, seed=1)
    js, ts = J.read_gas_optics_schema(path), T.read_gas_optics_schema(path)
    assert {k: js[k] for k in ("inputs", "lw", "ny", "ng", "nx", "nh")} \
        == {k: ts[k] for k in ("inputs", "lw", "ny", "ng", "nx", "nh")}
    for k in T._NEED:
        np.testing.assert_array_equal(ts[k], js[k])
    jmod, jparams, _ = J.load_gas_optics_weights(path, reduce_to=reduce_to)
    tmod, _ = T.load_gas_optics_weights(path, reduce_to=reduce_to,
                                        device="cpu")
    if reduce_to is not None:
        # the fresh head is each package's own draw: carry JAX's across
        tmod.load_state_dict(from_flax_params(
            jax.tree_util.tree_map(np.asarray, jparams), tmod))
    else:
        flat = from_flax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                tmod)
        for k, v in tmod.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), flat[k].numpy())
    x, col = _inputs(ts["nx"])
    want = jit_o0(jmod.apply, jparams, x, col)
    with torch.no_grad():
        got = tmod(torch.as_tensor(x), torch.as_tensor(col))
    want, got = (want, got) if lw else ((want,), (got,))
    ng = reduce_to or ts["ng"]
    for g, w in zip(got, want):
        assert tuple(g.shape) == (4, 9, ng)
        assert _rel(g, w) <= RTOL, _rel(g, w)


def test_writers_write_the_same_file(tmp_path):
    a, b = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    J.write_gas_optics_weights(a, lw=True, nx=9, nh=16, ng=12, seed=4)
    T.write_gas_optics_weights(b, lw=True, nx=9, nh=16, ng=12, seed=4)
    ra, rb = T.read_gas_optics_schema(a), T.read_gas_optics_schema(b)
    assert ra["inputs"] == rb["inputs"] and "cfc11" in ra["inputs"]
    for k in T._NEED:
        np.testing.assert_array_equal(ra[k], rb[k])
    assert not T.available(str(tmp_path / "absent.nc"))
    assert T.load_gas_optics_weights(str(tmp_path / "absent.nc")) is None


def test_band_helpers_match_jax():
    for n in (2, 3, 5, 14):
        assert T.band_gpt_bounds(n) == J.band_gpt_bounds(n)
    bounds = [0, 29, 71, 80, 89, 102, 112]
    edges = T.rrtmgp_bounds_to_wavenum_bounds(bounds)
    assert edges == J.rrtmgp_bounds_to_wavenum_bounds(bounds)
    np.testing.assert_array_equal(T.slingo_band_weights(edges),
                                  J.slingo_band_weights(edges))
    raw = np.random.default_rng(2).normal(0, 1, 16).astype(np.float32)
    band = [0, 4, 7, 11, 13, 14, 16]
    got = T.reduced_solar_weights(torch.as_tensor(raw), band, bounds,
                                  T.RRTMGP_SW_SOLAR_SOURCE)
    want = jit_o0(lambda r: J.reduced_solar_weights(
        r, band, bounds, J.RRTMGP_SW_SOLAR_SOURCE), raw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-6


def test_reduced_checkpoint_and_retrain(tmp_path):
    """A torch checkpoint of the reference's layout (rnn/utils.py:553-613)
    loads as JAX's loader loads it, and the retrain flow steps only the
    head."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    state = {"mlp1.weight": r(12, 7), "mlp1.bias": r(12),
             "mlp2.weight": r(12, 12), "mlp2.bias": r(12),
             "mlp3.weight": r(16, 12), "mlp3.bias": r(16),
             "xmin": torch.zeros(7), "xmax": torch.ones(7),
             "sw_solar_weights": r(16)}
    path = str(tmp_path / "sw_gasopt_bnd29-71-80-89-102_ng4-3-4-2-1-2.pt")
    torch.save({"model_state_dict": state, "do_norm": False}, path)
    jmod, jparams, jmeta = J.load_reduced_checkpoint(path)
    tmod, tmeta = T.load_reduced_checkpoint(path, device="cpu")
    assert tmeta["native_bounds"] == jmeta["native_bounds"] \
        == [0, 29, 71, 80, 89, 102, 112]
    assert tmeta["coeff"] == jmeta["coeff"] == 1e-17
    x, col = _inputs(7)
    want = jit_o0(jmod.apply, jparams, x, col)
    with torch.no_grad():
        got = tmod(torch.as_tensor(x), torch.as_tensor(col))
    assert _rel(got, want) <= RTOL
    opt = T.reduced_retrain_tx(tmod, lr=1e-2)
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    tmod(torch.as_tensor(x), torch.as_tensor(col)).mean().backward()
    opt.step()
    after = tmod.state_dict()
    for k in before:
        moved = not torch.equal(before[k], after[k])
        assert moved == k.startswith("mlp3"), k


def test_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "w.nc")
    T.write_gas_optics_weights(path, nx=7, nh=8, ng=6, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.load_gas_optics_weights(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.RRTMGPGasOptics(nx=7, nh=8, ng=6)
    assert T.load_gas_optics_weights(path, device="cpu")[0].xmin.device \
        == torch.device("cpu")
