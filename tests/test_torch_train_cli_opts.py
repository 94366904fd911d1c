"""The port's rollout-training CLI (``climsim_tpu_torch/cli/train_rollout.py``)
on its own, on the CPU: the options that are not ported yet raise before
any data is built, the device rules, training on its synthetic series
(with autograd off around it too), ``val_epoch_start``,
``eval_report_every`` and the two-strikes exit."""
import os

import numpy as np
import pytest
import torch

from climsim_tpu_torch.cli import train_rollout as cli
from climsim_tpu_torch.train.config import load_config
from test_torch_train_cli import GRU, NCOL, REPO, read_log, write_grid


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """These CPU runs are small: two intra-op threads a worker keep the
    suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    grid = str(tmp_path_factory.mktemp("cli_opts") / "grid.nc")
    write_grid(grid)
    return {"grid": grid}


@pytest.mark.parametrize("yaml,over,item", [
    ("autoreg_srnn.yaml", [], "A.12"),
    ("autoreg_longwindows.yaml", [], "A.13"),
    ("autoreg_gru.yaml", ["optimizer.name=muon"], "A.13"),
    ("autoreg_gru.yaml", ["rollout.ensemble_size=2"], "A.7"),
    ("autoreg_gru.yaml", ["loss.w_det=0.1"], "A.7"),
    ("autoreg_gru.yaml", ["optimizer.name=schedulefree"], "A.13"),
    ("autoreg_gru.yaml", ["export_path=e"], "A.16")])
def test_unported_options_raise_before_data(yaml, over, item, monkeypatch):
    """Each raises NotImplementedError naming its item before any data is
    built (the data loader must not be reached; no grid file exists)."""
    def no_data(*a, **k):
        raise AssertionError("data was built")
    monkeypatch.setattr(cli, "load_data", no_data)
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        cli.main([os.path.join(REPO, "conf", yaml), "device=cpu",
                  "grid_path=/nonexistent/grid.nc"] + over)


def test_device_rules(monkeypatch):
    """cuda by default, which raises without a card; device=cpu and
    JAX's platform=cpu run on the CPU; another platform raises."""
    cfg = lambda *o: load_config(GRU, list(o))
    assert cli.cli_device(cfg("device=cpu")).type == "cpu"
    assert cli.cli_device(cfg("platform=cpu")).type == "cpu"
    with pytest.raises(ValueError, match="platform"):
        cli.cli_device(cfg("platform=tpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([GRU])


@pytest.mark.parametrize("grad", [True, False])
def test_synthetic_data_defaults_run(files, tmp_path, grad):
    """Without data.h5_path the CLI trains on its synthetic series (from
    data.seed, on the grid's device) through the yaml's W 1 epochs, the
    same with autograd off around it (the updates turn it on)."""
    log = str(tmp_path / "log.jsonl")
    with torch.set_grad_enabled(grad):
        assert cli.main([GRU, "device=cpu", "epochs=1", "model.nneur=[8,8]",
                         f"grid_path={files['grid']}", f"data.ncol={NCOL}",
                         "data.steps=6", f"log_path={log}"]) == 0
    (rec,) = read_log(log)
    assert np.isfinite(rec["loss"]) and np.isfinite(rec["val_loss"])
    assert rec["updates"] == 4


def test_val_epoch_start_report_every_and_two_strikes(files, tmp_path):
    """val_epoch_start 1: epoch 0's val_loss is its loss; eval_report_every
    1 puts the scoreboard (without r2_lev) in every record; a non-finite
    epoch loss exits 2 before any checkpoint, as in JAX."""
    log = str(tmp_path / "log.jsonl")
    small = [GRU, "device=cpu", "model.nneur=[8,8]",
             f"grid_path={files['grid']}", f"data.ncol={NCOL}",
             "data.steps=6"]
    assert cli.main(small + ["epochs=2", "val_epoch_start=1",
                             "eval_report_every=1", f"log_path={log}"]) == 0
    r0, r1 = read_log(log)
    assert r0["val_loss"] == r0["loss"] and r1["val_loss"] != r1["loss"]
    assert "R2_dT" in r0 and "R2_dT" in r1 and "r2_lev" not in r0
    ck = str(tmp_path / "ck")
    assert cli.main(small + ["epochs=2", "optimizer.lr=1e30",
                             f"checkpoint_dir={ck}"]) == 2
    assert not os.path.exists(os.path.join(ck, "index.json"))
