"""The port's coupled-step CLI (``climsim_tpu_torch/cli/run_hybrid.py``)
against the JAX package's (``climsim_tpu/cli/run_hybrid.py``) on a
fabricated 384-column grid file, on the CPU: the function-level rollout
against JAX's HybridLoop on the same converted weights and JAX's initial
state, the CLI's output file against the JAX CLI's, a checkpoint round
trip, and the refusal to run without a card unless asked for the CPU.
JAX runs with x64 off, as its CLI runs."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from climsim_tpu.cli.run_hybrid import main as jax_main
from climsim_tpu.data import synthetic as JS
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.models.rnn import RNNAutoreg as JaxRNNAutoreg
from climsim_tpu.online.host_loop import (HostLoopConfig as JaxConfig,
                                          HybridLoop as JaxLoop)
from climsim_tpu_torch import Grid
from climsim_tpu_torch.cli import run_hybrid as cli
from climsim_tpu_torch.models import from_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCOL, NLEV, NNEUR, STEPS = 384, 60, 32, 4


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    """Grid.synthetic(384)'s arrays and P0 as a CDF-1 grid file."""
    path = str(tmp_path_factory.mktemp("grid") / "grid.nc")
    g = Grid.synthetic(NCOL, NLEV, dtype=torch.float64)
    with netcdf_file(path, "w") as f:
        f.createDimension("ncol", NCOL)
        f.createDimension("lev", NLEV)
        f.createDimension("ilev", NLEV + 1)
        for k, d in (("lat", "ncol"), ("lon", "ncol"), ("area", "ncol"),
                     ("hyai", "ilev"), ("hybi", "ilev"), ("hyam", "lev"),
                     ("hybm", "lev")):
            f.createVariable(k, "d", (d,))[:] = getattr(g, k).numpy()
        f.createVariable("P0", "d", ())[...] = 1.0e5
    return path


def _jax_rollout(path, scheme):
    """What the JAX CLI computes (run_hybrid.py:44-87) at nneur 32 and
    STEPS steps: the rollout, the flax parameters and the initial state."""
    with jax.enable_x64(False):
        grid = JaxGrid.from_file(path)
        tt = lambda a: tuple(float(x) for x in np.asarray(a))
        model = JaxRNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8,
                              nneur=(NNEUR, NNEUR), nh_mem=16,
                              hyam=tt(grid.hyam), hybm=tt(grid.hybm),
                              sp_mean=0.0, sp_div=1.0, add_pres=False,
                              output_prune=True)
        s0 = JS.generate_state(jax.random.PRNGKey(0),
                               JS.SyntheticConfig(vset_name="v1"), grid)
        state = {"T": s0["state_t"], "qv": s0["state_q0001"],
                 "qc": s0["state_q0002"], "qi": s0["state_q0003"],
                 "u": s0["state_u"], "v": s0["state_v"]}
        x_sfc = jnp.stack([s0[k] for k in cli.SFC_FIELDS]
                          + [jnp.zeros_like(s0["state_ps"])] * 17, axis=1)
        mem0 = jnp.zeros((grid.ncol, grid.nlev, 16), jnp.float32)
        xm = jnp.stack([state[k] for k in cli.PROGNOSTIC], axis=-1)
        params = model.init(jax.random.PRNGKey(1), xm, x_sfc, mem0)

        def emulator(x_main, x_sfc_in, mem):
            out, out_sfc, mem = model.apply(params, x_main, x_sfc_in, mem)
            return out * 1e-6, out_sfc * 1e-6, mem

        loop = JaxLoop(emulator, grid, JaxConfig(scheme=scheme))
        final, mem, diags = jax.jit(
            lambda s, m: loop.rollout(s, m, x_sfc, STEPS))(state, mem0)
        out = jax.tree_util.tree_map(np.asarray, (final, mem, diags))
        host = jax.tree_util.tree_map(np.asarray, (params, state, x_sfc))
    return out, host


@pytest.mark.parametrize("scheme", ["fv", "semi_lagrangian", "none"])
def test_rollout_matches_jax_cli(grid_file, scheme):
    """STEPS steps of the port's CLI rollout (``cli.run`` on the port's
    ``Grid.from_file`` and ``build_model``, JAX's weights through
    from_flax_params, JAX's initial state) against the JAX CLI's, under
    tests/test_torch_host_loop.py's tolerances: T to 1e-4 K (the f32
    state at ~250 K through the fixers' f32 sums), u and v to 1e-5, the
    tracers to rtol 1e-5, the memory and the diagnostics to 1e-5 / 1e-6.
    One absolute part is added: the CLI's smoke-mode tendencies (1e-6
    times outputs of order 1, times 1,200 s) move qv by ~1e-3 a step, a
    hundred times the moisture aloft, so where the steps' increments
    cancel a field carries their rounding. Each field is therefore also
    held to 1e-5 of its largest change over the run (the emulator's own
    tolerance, the memory's rtol), which the clipped tracers need with
    every scheme, transport or none. And the CLI feeds the emulator raw
    units (T ~250 K where a normalised input is of order 1), so the
    memory, an unbounded head of the 60-level GRU, carries rounding of a
    few 1e-6 of its scale: it is held to 1e-5 of its largest value."""
    (jfinal, jmem, jdiags), (params, state, x_sfc) = _jax_rollout(grid_file,
                                                                 scheme)
    grid = Grid.from_file(grid_file, device="cpu")
    model = cli.build_model(grid, NNEUR, 16, "cpu")
    assert model.arm == "scan"
    model.load_state_dict(from_flax_params(params, model))
    final, mem, diags, _ = cli.run(
        model, grid, {k: torch.tensor(v) for k, v in state.items()},
        torch.tensor(x_sfc), STEPS, scheme, 1e-6, "cpu")
    tol = {"T": (1e-6, 1e-4), "u": (1e-5, 1e-5), "v": (1e-5, 1e-5)}
    assert set(final) == set(jfinal)
    for k in jfinal:
        rtol, atol = tol.get(k, (1e-5, 1e-12))
        change = np.abs(jfinal[k] - state[k]).max()
        np.testing.assert_allclose(final[k].numpy(), jfinal[k], rtol=rtol,
                                   atol=max(atol, 1e-5 * change), err_msg=k)
    np.testing.assert_allclose(mem.numpy(), jmem, rtol=1e-5,
                               atol=1e-5 * np.abs(jmem).max())
    assert set(diags) == set(jdiags)
    for k in ("mean_T", "precc", "sfc_fluxes", "energy_int"):
        if k in jdiags:
            np.testing.assert_allclose(diags[k].numpy(), jdiags[k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    if "energy_resid" in jdiags:
        er = jdiags["energy_resid"]
        np.testing.assert_allclose(diags["energy_resid"].numpy(), er, rtol=0,
                                   atol=1e-4 * np.abs(er).max())
    assert diags["mean_T"].shape == (STEPS,)


def test_cli_writes_the_jax_clis_keys(grid_file, tmp_path):
    """``python -m climsim_tpu_torch.cli.run_hybrid --device cpu`` exits 0,
    reports finite fields and writes the keys, shapes and dtypes the JAX
    CLI writes for the same flags."""
    out = str(tmp_path / "port.npz")
    r = subprocess.run([sys.executable, "-m",
                        "climsim_tpu_torch.cli.run_hybrid", "--device",
                        "cpu", "--grid", grid_file, "--steps", str(STEPS),
                        "--nneur", str(NNEUR), "--out", out], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "finite: True" in r.stdout
    assert f"hybrid rollout: {STEPS} coupled steps" in r.stdout
    jout = str(tmp_path / "jax.npz")
    with jax.enable_x64(False):
        assert jax_main(["--grid", grid_file, "--steps", str(STEPS),
                         "--nneur", str(NNEUR), "--out", jout]) == 0
    got, want = np.load(out), np.load(jout)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert (got[k].shape, got[k].dtype) == (want[k].shape,
                                                want[k].dtype), k
        assert np.isfinite(got[k]).all(), k
    assert got["mean_T"].shape == (STEPS,)


def test_checkpoint_round_trip(grid_file, tmp_path, capsys):
    """A state dict saved with torch.save and passed as --checkpoint runs
    undamped and reproduces, bit for bit, the function-level rollout of
    the same weights from the CLI's initial state (generator seed 0). The
    weights are the CLI's model with its output heads scaled by 1e-6, a
    stand-in for trained tendencies of physical size."""
    grid = Grid.from_file(grid_file, device="cpu")
    model = cli.build_model(grid, NNEUR, 16, "cpu", seed=5)
    with torch.no_grad():
        for head in (model.mlp_output, model.mlp_surface_output):
            head.kernel.mul_(1e-6)
            head.bias.add_(1e-7)
    ckpt, out = str(tmp_path / "model.pt"), str(tmp_path / "d.npz")
    torch.save(model.state_dict(), ckpt)
    assert cli.main(["--device", "cpu", "--grid", grid_file, "--steps",
                     str(STEPS), "--nneur", str(NNEUR), "--checkpoint",
                     ckpt, "--out", out]) == 0
    assert "finite: True" in capsys.readouterr().out
    state, x_sfc = cli.initial_state(grid, torch.Generator().manual_seed(0))
    final, _, diags, _ = cli.run(model, grid, state, x_sfc, STEPS, "fv",
                                 1.0, "cpu")
    d = np.load(out)
    np.testing.assert_array_equal(d["mean_T"], diags["mean_T"].numpy())
    np.testing.assert_array_equal(d["precc"], diags["precc"].numpy())
    for k, v in final.items():
        np.testing.assert_array_equal(d[k], v.numpy(), err_msg=k)
    # undamped: the heads' bias moves the state past smoke mode's 1e-6
    smoke = cli.run(model, grid, state, x_sfc, STEPS, "fv", 1e-6, "cpu")[0]
    assert not torch.equal(final["T"], smoke["T"])


def test_cli_needs_the_card_unless_asked_for_the_cpu(grid_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--grid", grid_file, "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--grid", grid_file, "--steps", "1", "--device", "cuda"])
