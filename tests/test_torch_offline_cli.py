"""The port's offline CLIs on the CPU: ``cli/train_offline.py`` on
``conf/mlp_v1.yaml`` and ``conf/cnn_v1.yaml`` as a user runs them (2
epochs, 6 steps of synthetic data, narrow widths, ``device=cpu``), and
with ``model.name=ed``: 2 epoch records, the scoreboard table and its CSV;
then ``cli/evaluate.py`` on the validation arrays of that run against
the JAX package's evaluation CLI on the same arrays and norm files, CSV
row for row at rtol 1e-5 (the float32 chain in another order; an
absolute floor of 1e-6 of each column's largest magnitude). The port's
evaluation also reproduces the training CLI's own scoreboard (rtol 1e-5:
it recovers ps from the normalized inputs). The unported arms raise
naming their ROADMAP ids before any data is built."""
import json
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.io import netcdf_file

import climsim_tpu.cli.evaluate as jax_evaluate
from climsim_tpu_torch import variables as V
from climsim_tpu_torch.cli import evaluate as port_evaluate
from climsim_tpu_torch.cli import train_offline as cli
from climsim_tpu_torch.data import synthetic as S
from test_torch_train_cli import REPO, write_grid

CONF = os.path.join(REPO, "conf")
COMMON = ["device=cpu", "epochs=2", "data.steps=6"]
ARMS = {"mlp": ("mlp_v1.yaml", ["model.features=[32,32]"]),
        "cnn": ("cnn_v1.yaml", ["model.depth=2", "model.channels=16"]),
        "ed": ("mlp_v1.yaml", ["model.name=ed", "model.intermediate_dim=64"])}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_norm_files(root, vset, nz):
    """The normalizer ``nz`` as the ClimSim norm files under
    ``root/preprocessing/normalizations``: per-variable input mean, max
    (= the divisor) and min (= 0), and output scale, so that
    ``Normalizer.from_files`` gives ``nz`` back exactly."""
    base = os.path.join(root, "preprocessing", "normalizations")
    for sub in ("inputs", "outputs"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    flat = lambda t: np.asarray(t.cpu().numpy(), np.float64)
    files = {"inputs/input_mean.nc": (vset.inputs, flat(nz.mean)),
             "inputs/input_max.nc": (vset.inputs, flat(nz.div)),
             "inputs/input_min.nc": (vset.inputs, 0 * flat(nz.div)),
             "outputs/output_scale.nc": (vset.outputs, flat(nz.scale))}
    for name, (layout, values) in files.items():
        with netcdf_file(os.path.join(base, name), "w") as f:
            f.createDimension("lev", V.NLEV)
            for var in layout.names:
                sl = layout.slices[var]
                dims = ("lev",) if sl.stop - sl.start == V.NLEV else ()
                f.createVariable(var, "d", dims)[...] = values[sl]


def run_cli(tmp_path, arm, capsys, monkeypatch):
    """The CLI's main in ``tmp_path`` (grid file at its default place),
    its setup kept: (exit code, printed lines, records, the Offline)."""
    monkeypatch.chdir(tmp_path)
    if not os.path.exists("grid_info"):
        os.makedirs("grid_info")
        write_grid("grid_info/ClimSim_low-res_grid-info.nc", 384)
    runs = []
    orig = cli.setup
    monkeypatch.setattr(cli, "setup",
                        lambda cfg: runs.append(orig(cfg)) or runs[-1])
    yaml, over = ARMS[arm]
    rc = cli.main([os.path.join(CONF, yaml)] + COMMON + over
                  + [f"metrics_csv={arm}.csv"])
    lines = capsys.readouterr().out.splitlines()
    records = [json.loads(ln) for ln in lines if ln.startswith('{"epoch"')]
    return rc, lines, records, runs[0]


@pytest.mark.parametrize("arm", list(ARMS))
def test_train_offline_runs_the_yamls(tmp_path, arm, capsys, monkeypatch):
    """2 finite epoch records with JAX's keys, the scoreboard printed as
    the CSV's frame rounded to 4 decimals, every output variable in the
    CSV; the CNN yaml's batch 768 gives 2 updates an epoch
    on 1,536 training rows, the MLP yaml's 1,536 one."""
    rc, lines, records, run = run_cli(tmp_path, arm, capsys, monkeypatch)
    assert rc == 0
    assert [r["epoch"] for r in records] == [0, 1]
    for r in records:
        assert set(r) == {"epoch", "train_loss", "seconds", "val_loss",
                          "val_r2"}
        assert np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
    assert run.ntr == 1536 and run.model.__class__.__name__ == arm.upper()
    df = pd.read_csv(f"{arm}.csv", index_col=0)
    assert list(df.index) == list(V.get("v1").outputs.names)
    assert list(df.columns) == ["MAE", "RMSE", "R2", "bias"]
    table = df.round(4).to_string().splitlines()
    assert lines[-len(table):] == table
    assert table[-1].startswith("cam_out_SOLLD")


def test_evaluate_matches_jax_csv(tmp_path, capsys, monkeypatch):
    """The MLP run's validation block (normalized inputs, scaled targets,
    the model's predictions) as flat npy files and its normalizer as
    norm files: both evaluation CLIs write the same per-variable and
    per-level CSVs, and the per-variable one equals the training CLI's
    scoreboard."""
    _, _, _, run = run_cli(tmp_path, "mlp", capsys, monkeypatch)
    nval = (len(run.xn) - run.ntr) // 384 * 384
    lo, hi = run.ntr, run.ntr + nval
    with torch.no_grad():
        pred = run.model(run.xn[lo:hi])
    for name, t in (("x", run.xn[lo:hi]), ("y", run.yn[lo:hi]),
                    ("p", pred)):
        np.save(f"{name}.npy", t.numpy())
    write_norm_files(tmp_path, run.vset, run.nz)
    args = ["--input", "x.npy", "--target", "y.npy", "--pred", "p.npy",
            "--grid", "grid_info/ClimSim_low-res_grid-info.nc"]
    assert port_evaluate.main(args + ["--device", "cpu", "--out",
                                      "port.csv", "--out-lev",
                                      "port_lev.csv"]) == 0
    monkeypatch.setattr(jax_evaluate, "NORM", str(
        tmp_path / "preprocessing" / "normalizations"))
    with jax.enable_x64(False):
        assert jax_evaluate.main(args + ["--out", "jax.csv", "--out-lev",
                                         "jax_lev.csv"]) == 0
    for ours, theirs, index in (("port.csv", "jax.csv", 0),
                                ("port_lev.csv", "jax_lev.csv", None)):
        got = pd.read_csv(ours, index_col=index, header=[0] if index == 0
                          else [0, 1])
        want = pd.read_csv(theirs, index_col=index, header=[0] if index == 0
                           else [0, 1])
        assert list(got.index) == list(want.index)
        assert list(got.columns) == list(want.columns)
        for c in want.columns:
            w = want[c].to_numpy()
            np.testing.assert_allclose(
                got[c].to_numpy(), w, rtol=1e-5,
                atol=1e-6 * np.nanmax(np.abs(w[np.isfinite(w)]), initial=0),
                err_msg=f"{ours} {c}")
    trained = pd.read_csv("mlp.csv", index_col=0)
    evaluated = pd.read_csv("port.csv", index_col=0)
    np.testing.assert_allclose(evaluated.to_numpy(), trained.to_numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("over,item", [
    (["model.name=unet"], "A.13, the rest"),
    (["model.name=classifier"], "A.13, the rest"),
    (["model.name=classifier_gradout"], "A.13, the rest"),
    (["model.name=hsr"], "A.13, the stochastic stack"),
    (["model.name=rpn"], "A.13, the stochastic stack"),
    (["model.name=cvae"], "A.13, the stochastic stack"),
    (["optimizer.name=soap"], "A.13, the optimizers"),
    (["optimizer.name=muon"], "A.13, the optimizers")])
def test_unported_arms_raise_before_data(over, item, monkeypatch):
    def no_data(*a, **k):
        raise AssertionError("data was built")
    monkeypatch.setattr(S, "make_timeseries", no_data)
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        cli.main([os.path.join(CONF, "mlp_v1.yaml"), "device=cpu",
                  "grid_path=/nonexistent/grid.nc"] + over)


def test_device_rules(tmp_path, monkeypatch):
    """The card by default, which raises without one (this machine has
    none); no arguments print the usage."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([os.path.join(CONF, "mlp_v1.yaml")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_evaluate.score(["--target", "t", "--pred", "p", "--ps", "s"])
    assert cli.main([]) == 1
