"""The rollout-training CLI on the two yamls this slice ports, on the CPU:
``conf/autoreg_longwindows.yaml`` (SOAP, remat, mixed replay, the energy
and water terms) against the JAX package's CLI in-process, and
``conf/autoreg_srnn.yaml`` (the stochastic layer, AR(1) noise, a
4-member ensemble on CRPS) through ``main`` with checkpoints and
``resume``.

The longwindows comparison follows test_torch_train_cli.py: both CLIs
read the same keeplev file and grid file, the port starts from JAX's
initial weights, and JAX is given ``loss.w_wcon=3e7`` (its YAML 1.1
reader makes the yaml's ``3.0e7`` a string; ROADMAP C). Two draws are
replayed from JAX's run into the port's: the mixed-replay masks (JAX's
``uniform(split(key))`` sequence from ``PRNGKey(seed + epoch)``) and
SOAP's bases (tests/torch_soap_replay.py: the first basis of a
rectangular weight leaves a degenerate eigenvalue's rotation free), and
the refresh's sort of the eigenvalue estimates where the port's order
differs from JAX's among estimates within 1e-3 of each other (two
estimates 1.9e-4 apart swap by rounding at some hash salts; ROADMAP C.3)
and nowhere else."""
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from climsim_tpu.cli.train_rollout import main as jax_main
from climsim_tpu_torch.cli import train_rollout as cli
from climsim_tpu_torch.models import from_flax_params
from climsim_tpu_torch.train import RolloutTrainer
from climsim_tpu_torch.train.config import load_config
from test_torch_train_cli import (NCOL, REPO, read_log, write_data,
                                  write_grid)
from torch_soap_replay import BasisLog, record_jax, replay_port

LW = os.path.join(REPO, "conf", "autoreg_longwindows.yaml")
SRNN = os.path.join(REPO, "conf", "autoreg_srnn.yaml")
STEPS = 16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_stoch")
    grid, data = str(root / "grid.nc"), str(root / "data.h5")
    write_grid(grid)
    write_data(data, grid, steps=STEPS)
    return {"root": root, "grid": grid, "data": data}


class JaxMasks:
    """The port's mixed-replay masks replaced by JAX's: each epoch's
    generator (seeded with seed + epoch, as JAX's key) stands for
    PRNGKey(seed + epoch), and every draw splits it as JAX's epochs do."""

    def __init__(self):
        self.keys = {}
        self.draws = 0

    def __call__(self, trainer, B, frac, gen):
        if trainer.cfg.replay != "mixed":
            return None
        _, key = self.keys.setdefault(
            id(gen), (gen, jax.random.PRNGKey(gen.initial_seed())))
        key, km = jax.random.split(key)
        self.keys[id(gen)] = (gen, key)
        self.draws += 1
        with jax.enable_x64(False):
            m = np.array(jax.random.uniform(km, (B,)) < frac, np.float32)
        return torch.tensor(m, device=trainer.device)


def test_longwindows_cli_matches_jax(files, tmp_path, monkeypatch):
    """3 epochs at W 1, 2 and 3 (the schedule compressed; 22 SOAP updates,
    so the first bases and two refreshes), 16-wide GRU sweeps on 32
    columns: every record's loss and val_loss within rtol 1e-4 of JAX's,
    the other keys equal."""
    common = ["model.nneur=[16,16]", f"data.ncol={NCOL}",
              f"data.h5_path={files['data']}", f"grid_path={files['grid']}",
              "rollout.schedule={0: 1, 1: 2, 2: 3}"]
    jax_only = ["platform=cpu", "loss.w_wcon=3e7"]
    # JAX's initial weights: one epoch at learning rate 0 (SOAP's first
    # update moves nothing anyway), restored from its checkpoint
    ck0 = str(tmp_path / "jax_ck0")
    with jax.enable_x64(False):
        assert jax_main([LW, "epochs=1", "optimizer.lr=0",
                         f"checkpoint_dir={ck0}"] + jax_only + common) == 0
    tree = ocp.PyTreeCheckpointer().restore(os.path.join(ck0, "ep0"))
    run = cli.setup(load_config(LW, common + ["device=cpu"]))
    w0 = str(tmp_path / "w0.pt")
    torch.save(from_flax_params(tree["params"], run.trainer.model), w0)

    jlog, tlog = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    log = BasisLog()
    with record_jax(log), jax.enable_x64(False):
        assert jax_main([LW, "epochs=3", f"log_path={jlog}"] + jax_only
                        + common) == 0
    masks = JaxMasks()
    monkeypatch.setattr(RolloutTrainer, "_mix_mask",
                        lambda self, B, frac, gen: masks(self, B, frac, gen))
    with replay_port(log):
        assert cli.main([LW, "device=cpu", "epochs=3", f"init_from={w0}",
                         f"log_path={tlog}"] + common) == 0
    want, got = read_log(jlog), read_log(tlog)
    assert [r["window"] for r in got] == [1, 2, 3]
    assert [r["updates"] for r in got] == [12, 6, 4]
    # the masks of each training chunk and validation window were JAX's
    assert masks.draws > 3
    # every basis the port computed was one of JAX's, and every refresh's
    # sort JAX's order (the port's own but among near-equal estimates)
    n_qr = sum(k == "qr" for k, _, _ in log.entries)
    assert log.replayed == sum(k == "eigh" for k, _, _ in log.entries) \
        + n_qr > 0
    assert log.sorted == n_qr > 0
    print(f"bases replayed {log.replayed}, sorts {log.sorted}, of which "
          f"in JAX's order where the port's differed {log.reordered}")
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("epoch", "window", "mix_frac", "updates", "dispatches"):
            assert g[k] == w[k], k
        for k in ("loss", "val_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


def test_srnn_cli_checkpoints_and_resume(files, tmp_path):
    """conf/autoreg_srnn.yaml as written but for its size and schedule
    ({0: 1, 1: 2}, so the AR(1) noise is carried through a W 2 window):
    finite records, a checkpoint of the [4, B, L, nm] memory, and a run
    resumed after epoch 0 gives epoch 1's record of the straight run
    (the noise is keyed by seed, step and member, not drawn from a
    stream)."""
    common = ["device=cpu", "model.nneur=[8,8]", f"data.ncol={NCOL}",
              f"data.h5_path={files['data']}", f"grid_path={files['grid']}",
              "rollout.schedule={0: 1, 1: 2}"]
    straight = str(tmp_path / "straight.jsonl")
    assert cli.main([SRNN, "epochs=2", f"log_path={straight}"]
                    + common) == 0
    ck, log = str(tmp_path / "ck"), str(tmp_path / "log.jsonl")
    assert cli.main([SRNN, "epochs=1", f"checkpoint_dir={ck}",
                     f"log_path={log}"] + common) == 0
    saved = torch.load(os.path.join(ck, "ep0.pt"), weights_only=True)
    assert saved["mem"].shape == (4, NCOL, 60, 16)
    assert torch.isfinite(saved["mem"]).all()
    assert cli.main([SRNN, "epochs=2", "resume=true", f"checkpoint_dir={ck}",
                     f"log_path={log}"] + common) == 0
    want, got = read_log(straight), read_log(log)
    assert [r["window"] for r in want] == [1, 2]
    for r in want:
        assert np.isfinite(r["loss"]) and np.isfinite(r["val_loss"])
    assert got[0]["epoch"] == 0 and got[1]["epoch"] == 1
    for k in ("loss", "val_loss", "updates"):
        assert got[0][k] == want[0][k], k
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-6,
                                   err_msg=k)
