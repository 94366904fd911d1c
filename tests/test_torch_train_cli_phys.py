"""The port's training CLI on the physics yaml (``conf/autoreg_physrnn.yaml``:
nreg 8, McICA, qv variability, physical radiation, the scan trunk)
against the JAX package's on the CPU, one epoch at learning rate 0: the
forward, the losses and the scoreboard from the same keeplev file, grid
and initial weights.

Two faults of the JAX reference shape this test:

* JAX reads the yaml's ``w_wcon: 3.0e7`` as a string (PyYAML's YAML 1.1)
  and fails at its first update; it is given ``loss.w_wcon=3e7``;
* JAX's jitted update of this model gives non-finite gradients on the
  CLI's synthetic data (finite when the same function runs op by op),
  and Adam turns them into NaN parameters even at learning rate
  0. So JAX runs with jit disabled, op by op (about 25 s an update here,
  which is why the series is 3 steps long: 2 updates and 1 validation
  step).
"""
import json
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from climsim_tpu.cli.train_rollout import main as jax_main
from climsim_tpu_torch.cli import train_rollout as cli
from climsim_tpu_torch.models import from_flax_params
from climsim_tpu_torch.train.config import load_config
from test_torch_train_cli import NCOL, read_log, write_data, write_grid

PHYS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "conf", "autoreg_physrnn.yaml")
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """These CPU runs are small: two intra-op threads a worker keep the
    suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lr0_runs(tmp_path_factory):
    """One epoch of each CLI at learning rate 0 with eval_report; the port
    from JAX's initial weights (its checkpoint, whose parameters the lr-0
    epoch left as they were)."""
    root = tmp_path_factory.mktemp("phys")
    grid, data = str(root / "grid.nc"), str(root / "data.h5")
    write_grid(grid)
    write_data(data, grid, STEPS)
    common = ["epochs=1", "model.nneur=[16,16]", f"data.ncol={NCOL}",
              f"data.h5_path={data}", f"grid_path={grid}",
              "optimizer.lr=0", "eval_report=true"]
    ck, jlog, tlog = (str(root / n) for n in ("ck", "j.jsonl", "t.jsonl"))
    with jax.enable_x64(False), jax.disable_jit():
        assert jax_main([PHYS, "platform=cpu", "loss.w_wcon=3e7",
                         f"checkpoint_dir={ck}", f"log_path={jlog}"]
                        + common) == 0
    tree = ocp.PyTreeCheckpointer().restore(os.path.join(ck, "ep0"))
    run = cli.setup(load_config(PHYS, common + ["device=cpu"]))
    w0 = str(root / "w0.pt")
    torch.save(from_flax_params(tree["params"], run.trainer.model), w0)
    assert cli.main([PHYS, "device=cpu", f"init_from={w0}",
                     f"log_path={tlog}"] + common) == 0
    return read_log(jlog), read_log(tlog), w0, common


def test_phys_records_match_jax(lr0_runs):
    """loss and val_loss within rtol 1e-4 (measured 5e-5: float32 through
    the microphysics and radiation with output scales near 1e12 where a
    synthetic tendency's spread vanishes); the other keys equal."""
    want, got, _, _ = lr0_runs
    (w, wrep), (g, grep) = want, got
    assert set(g) == set(w)
    for k in ("epoch", "window", "mix_frac", "updates", "dispatches"):
        assert g[k] == w[k], k
    assert g["updates"] == 2
    for k in ("loss", "val_loss"):
        assert np.isfinite(g[k])
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


def test_phys_scoreboard_matches_jax(lr0_runs):
    """Every scoreboard value within 5e-3 relative and the R2 profile
    within 1e-3: the model outputs agree to 2e-5 of their scale, and the
    random model's R2 = 1 - sse/tss amplifies that where sse is far above
    tss (R2 -125 for the shortwave fluxes moves by 1.8e-3 relative). The
    scoreboard's arithmetic itself is held to 1e-12 on equal inputs in
    test_torch_data.py."""
    (_, wrep), (_, grep) = lr0_runs[0], lr0_runs[1]
    want, got = wrep["eval_report"], grep["eval_report"]
    assert list(got) == list(want) and len(want) > 30
    for k, w in want.items():
        if k == "r2_lev":
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-3)
        else:
            np.testing.assert_allclose(got[k], w, rtol=5e-3, atol=1e-30,
                                       err_msg=k)


def test_phys_curriculum_checkpoint_and_fused_trunk(lr0_runs, tmp_path):
    """The port alone: W 1 then W 2 with the yaml's learning rate and a
    checkpoint, with the scan trunk and with use_pallas (the fused trunk,
    its plain versions on the CPU); finite records, index.json sorted."""
    _, _, _, common = lr0_runs
    base = [c for c in common if not c.startswith(("optimizer.lr",
                                                   "eval_report",
                                                   "epochs"))]
    for trunk in ("false", "true"):
        ck = str(tmp_path / f"ck{trunk}")
        log = str(tmp_path / f"{trunk}.jsonl")
        assert cli.main([PHYS, "device=cpu", "epochs=2",
                         "rollout.schedule={0: 1, 1: 2}",
                         f"model.use_pallas={trunk}", f"checkpoint_dir={ck}",
                         f"log_path={log}"] + base) == 0
        recs = read_log(log)
        assert [r["window"] for r in recs] == [1, 2]
        assert [r["updates"] for r in recs] == [2, 1]
        assert all(np.isfinite(r["loss"]) and np.isfinite(r["val_loss"])
                   for r in recs)
        index = json.load(open(os.path.join(ck, "index.json")))
        assert [e["val_loss"] for e in index] == sorted(
            r["val_loss"] for r in recs)
