"""The port's rollout-training CLI (``climsim_tpu_torch/cli/train_rollout.py``)
on its own, on the CPU: best-K checkpoints and ``resume``, the
checkpoint index's schema, ``init_from`` with ``freeze_patterns``,
``pred_export`` and ``eval_report``; from a keeplev file of the port's
synthetic series on a fabricated grid file."""
import json
import os

import numpy as np
import pytest
import torch

from climsim_tpu_torch.cli import train_rollout as cli
from climsim_tpu_torch.data import synthetic as S
from climsim_tpu_torch.data import write_timeseries
from climsim_tpu_torch import Grid
from climsim_tpu_torch.train.config import load_config
from climsim_tpu_torch.train.rollout import (restore_rollout_checkpoint,
                                             save_rollout_checkpoint)
from test_torch_train_cli import GRU, NCOL, NLEV, STEPS, read_log, \
    write_grid


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
    root = tmp_path_factory.mktemp("cli_ck")
    grid, data = str(root / "grid.nc"), str(root / "data.h5")
    write_grid(grid)
    series = S.make_timeseries(
        torch.Generator().manual_seed(0),
        S.SyntheticConfig(vset_name="v4_rnn", ncol=NCOL),
        Grid.from_file(grid, device="cpu"), STEPS, flat=False)
    write_timeseries(data, *series)
    common = ["model.nneur=[8,8]", f"data.ncol={NCOL}",
              f"data.h5_path={data}", f"grid_path={grid}"]
    return {"grid": grid, "data": data, "common": common}


def test_checkpoints_best_k_and_resume(files, tmp_path, capsys):
    """keep_top_k 2 over 3 epochs: index.json holds the 2 lowest
    val_loss entries, sorted, and only their files; resume continues at
    the best epoch + 1 from its weights, optimizer and memory."""
    ck = str(tmp_path / "ck")
    log = str(tmp_path / "log.jsonl")
    common = files["common"] + [
        "device=cpu", f"checkpoint_dir={ck}", "keep_top_k=2",
        f"log_path={log}", "rollout.schedule={0: 1, 1: 2}"]
    assert cli.main([GRU, "epochs=3"] + common) == 0
    recs = read_log(log)
    index = json.load(open(os.path.join(ck, "index.json")))
    assert [e["val_loss"] for e in index] == sorted(
        r["val_loss"] for r in recs)[:2]
    assert sorted(os.listdir(ck)) == sorted(
        [f"{e['name']}.pt" for e in index] + ["index.json"])
    best = index[0]["epoch"]
    run = cli.setup(load_config(GRU, files["common"] + ["device=cpu"]))
    mem, ep = restore_rollout_checkpoint(ck, run.trainer)
    saved = torch.load(os.path.join(ck, f"ep{best}.pt"), weights_only=True)
    assert ep == best and torch.equal(mem, saved["mem"])
    for k, v in run.trainer.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    assert run.trainer.opt.state_dict()["state"][0]["step"] == \
        saved["optimizer"]["state"][0]["step"]
    assert cli.main([GRU, "epochs=4", "resume=true"] + common) == 0
    assert f"resumed from {ck} at epoch {best}" in capsys.readouterr().out
    assert [r["epoch"] for r in read_log(log)[3:]] == list(range(best + 1, 4))


def test_checkpoint_index_schema(tmp_path):
    """save_rollout_checkpoint keeps JAX's index.json schema and order."""
    from climsim_tpu_torch.train import RolloutConfig, RolloutTrainer
    model = torch.nn.Linear(2, 2)
    model.nh_mem = 1
    tr = RolloutTrainer(model, RolloutConfig(), np.zeros(3), np.zeros(3),
                        device="cpu")
    mem = torch.zeros(2, 2, 1)
    for ep, vl in ((0, 3.0), (1, 1.0), (2, None), (3, 2.0)):
        save_rollout_checkpoint(str(tmp_path), tr, mem, ep, val_loss=vl,
                                keep_top_k=3)
    index = json.load(open(tmp_path / "index.json"))
    assert index == [{"name": "ep1", "epoch": 1, "val_loss": 1.0},
                     {"name": "ep3", "epoch": 3, "val_loss": 2.0},
                     {"name": "ep0", "epoch": 0, "val_loss": 3.0}]
    assert not (tmp_path / "ep2.pt").exists()


def test_init_from_freeze_and_pred_export(files, tmp_path):
    """init_from loads every tensor of a port checkpoint; freeze_patterns
    ('*rnn_up*', matched on the flax path) keep those parameters through
    an epoch while the rest move; pred_export writes the flat scoring
    triplet, and eval_report the scoreboard."""
    ck = str(tmp_path / "ck")
    assert cli.main([GRU, "epochs=1", "device=cpu", f"checkpoint_dir={ck}"]
                    + files["common"]) == 0
    donor = os.path.join(ck, "ep0.pt")
    ck2, pred = str(tmp_path / "ck2"), str(tmp_path / "pred")
    log = str(tmp_path / "log.jsonl")
    assert cli.main([GRU, "epochs=1", "device=cpu", f"init_from={donor}",
                     "freeze_patterns=['*rnn_up*']", f"checkpoint_dir={ck2}",
                     f"pred_export={pred}", "eval_report=true",
                     f"log_path={log}"] + files["common"]) == 0
    before = torch.load(donor, weights_only=True)["model"]
    after = torch.load(os.path.join(ck2, "ep0.pt"), weights_only=True)["model"]
    for k in before:
        same = torch.equal(before[k], after[k])
        assert same == ("rnn_up" in k), k
    p = np.load(os.path.join(pred, "scoring_pred.npy"))
    t = np.load(os.path.join(pred, "scoring_target.npy"))
    ps = np.load(os.path.join(pred, "scoring_ps.npy"))
    val_steps = STEPS - int(STEPS * 0.8)
    assert p.shape == t.shape == (val_steps * NCOL, 368)
    assert ps.shape == (val_steps * NCOL,) and np.isfinite(p).all()
    report = read_log(log)[-1]["eval_report"]
    assert len(report["r2_lev"]) == NLEV and "R2_dT" in report
