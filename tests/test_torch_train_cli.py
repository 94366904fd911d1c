"""The port's rollout-training CLI (``climsim_tpu_torch/cli/train_rollout.py``)
against the JAX package's (``climsim_tpu/cli/train_rollout.py``) on the
CPU: the GRU yaml's epoch records, and the reference-normalization yaml's
stop at its first absent file. The CLI's own behaviour is in
``test_torch_train_cli_{ckpt,opts}.py``.

The whole-slice parity: both CLIs read the same keeplev file (written by
JAX's ``write_timeseries`` from JAX's synthetic series) and the same grid
file, and the port starts from JAX's initial weights, taken from a JAX
run at learning rate 0 through its checkpoint and ``from_flax_params``.
JAX runs with x64 off, as its CLI does."""
import json
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from scipy.io import netcdf_file

from climsim_tpu.cli.train_rollout import main as jax_main
from climsim_tpu.data import synthetic as JS
from climsim_tpu.data import write_timeseries
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu_torch import Grid
from climsim_tpu_torch.cli import train_rollout as cli
from climsim_tpu_torch.models import from_flax_params
from climsim_tpu_torch.train.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCOL, NLEV, STEPS, NNEUR = 32, 60, 8, 16
GRU = os.path.join(REPO, "conf", "autoreg_gru.yaml")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """These CPU runs are small: two intra-op threads a worker keep the
    suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_grid(path, ncol=NCOL):
    """Grid.synthetic(ncol)'s arrays and P0 as a CDF-1 grid file."""
    g = Grid.synthetic(ncol, NLEV, dtype=torch.float64)
    with netcdf_file(path, "w") as f:
        f.createDimension("ncol", ncol)
        f.createDimension("lev", NLEV)
        f.createDimension("ilev", NLEV + 1)
        for k, d in (("lat", "ncol"), ("lon", "ncol"), ("area", "ncol"),
                     ("hyai", "ilev"), ("hybi", "ilev"), ("hyam", "lev"),
                     ("hybm", "lev")):
            f.createVariable(k, "d", (d,))[:] = getattr(g, k).numpy()
        f.createVariable("P0", "d", ())[...] = 1.0e5


def write_data(path, grid_path, steps=STEPS):
    """JAX's synthetic v4_rnn series on the grid file, as a keeplev file."""
    with jax.enable_x64(False):
        series = JS.make_timeseries(
            jax.random.PRNGKey(0), JS.SyntheticConfig(vset_name="v4_rnn",
                                                      ncol=NCOL),
            JaxGrid.from_file(grid_path), steps, flat=False)
    write_timeseries(path, *[np.array(a) for a in series])


def jax_weights(yaml, common, ckdir, model_overrides=()):
    """JAX's initial weights: its CLI run one epoch at learning rate 0
    (no update moves a parameter), restored from its checkpoint and
    mapped onto the port's model."""
    with jax.enable_x64(False):
        assert jax_main([yaml, "platform=cpu", "epochs=1", "optimizer.lr=0",
                         f"checkpoint_dir={ckdir}"] + common) == 0
    tree = ocp.PyTreeCheckpointer().restore(os.path.join(ckdir, "ep0"))
    run = cli.setup(load_config(yaml, common + ["device=cpu",
                                                *model_overrides]))
    return from_flax_params(tree["params"], run.trainer.model)


def read_log(path):
    return [json.loads(line) for line in open(path)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    grid, data = str(root / "grid.nc"), str(root / "data.h5")
    write_grid(grid)
    write_data(data, grid)
    common = [f"model.nneur=[{NNEUR},{NNEUR}]", f"data.ncol={NCOL}",
              f"data.h5_path={data}", f"grid_path={grid}"]
    w0 = str(root / "w0.pt")
    torch.save(jax_weights(GRU, common, str(root / "jax_ck0")), w0)
    return {"root": root, "grid": grid, "data": data, "common": common,
            "w0": w0}


def test_gru_cli_matches_jax(files, tmp_path):
    """conf/autoreg_gru.yaml, 2 epochs of 6 fused updates, replay null
    (as the yaml): every record's loss and val_loss within rtol 1e-4 of
    JAX's (float32 through 60 levels of two 16-wide GRU sweeps and 12
    Adam steps; measured 2e-6), the records' other keys equal."""
    common = files["common"] + ["epochs=2"]
    jlog, tlog = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with jax.enable_x64(False):
        assert jax_main([GRU, "platform=cpu", f"log_path={jlog}"]
                        + common) == 0
    assert cli.main([GRU, "device=cpu", f"init_from={files['w0']}",
                     f"log_path={tlog}"] + common) == 0
    want, got = read_log(jlog), read_log(tlog)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("epoch", "window", "mix_frac", "updates", "dispatches"):
            assert g[k] == w[k], k
        for k in ("loss", "val_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert got[0]["updates"] == 6 and got[0]["dispatches"] == 1


def test_gru_cli_non_fused_and_prev_channels(files, tmp_path):
    """The per-window epoch (fused=false) and the previous-step channels
    (6 inputs, 5 outputs; each split loses its first step): JAX's records
    within rtol 1e-4."""
    common = files["common"] + [
        "epochs=1", "fused=false", "data.include_prev_inputs=true",
        "data.include_prev_outputs=true"]
    w0 = str(tmp_path / "w0.pt")
    torch.save(jax_weights(GRU, common, str(tmp_path / "ck")), w0)
    jlog, tlog = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with jax.enable_x64(False):
        assert jax_main([GRU, "platform=cpu", f"log_path={jlog}"]
                        + common) == 0
    assert cli.main([GRU, "device=cpu", f"init_from={w0}",
                     f"log_path={tlog}"] + common) == 0
    (w,), (g,) = read_log(jlog), read_log(tlog)
    assert g["updates"] == w["updates"] == 5 and "dispatches" not in g
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


def test_refnorm_yaml_stops_at_the_first_norm_file(files):
    """conf/autoreg_gru_refnorm.yaml without the ClimSim files: the
    FileNotFoundError of the first normalization file read (the qc
    cloud-transform lambdas), the same as JAX's."""
    args = ["conf/autoreg_gru_refnorm.yaml", "model.nneur=[16,16]",
            f"grid_path={files['grid']}", f"data.ncol={NCOL}",
            f"data.steps={STEPS}"]
    with pytest.raises(FileNotFoundError) as jerr, jax.enable_x64(False):
        jax_main(args + ["platform=cpu"])
    with pytest.raises(FileNotFoundError) as terr:
        cli.main(args + ["device=cpu"])
    want = jerr.value.filename
    assert want == load_config(args[0]).data.lbd_qc_path
    assert terr.value.filename == want
