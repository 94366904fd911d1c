"""The rollout-training CLI with the model options of ROADMAP A.12 on the
GRU yaml (``model.cell=lstm``, ``model.memory=None`` and
``model.separate_radiation=true``, in one run) against the JAX package's CLI
in-process on the CPU, as tests/test_torch_train_cli.py holds the yaml as
written: both read the same keeplev and grid files, the port starts from
JAX's initial weights (taken from JAX's trainer as its run initializes
them, through ``from_flax_params``), and each epoch record's loss and
val_loss agree to rtol 1e-4, its other keys exactly."""
import jax
import numpy as np
import pytest

from climsim_tpu.cli.train_rollout import main as jax_main
from climsim_tpu.train import rollout as jrollout
from climsim_tpu_torch.cli import train_rollout as cli
from climsim_tpu_torch.models import from_flax_params
from climsim_tpu_torch.train.config import load_config
import torch

from test_torch_train_cli import (GRU, NCOL, NNEUR, read_log, write_data,
                                  write_grid)

OPTIONS = ["model.cell=lstm", "model.memory=None",
           "model.separate_radiation=true"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_a12")
    grid, data = str(root / "grid.nc"), str(root / "data.h5")
    write_grid(grid)
    write_data(data, grid)
    return {"common": [f"model.nneur=[{NNEUR},{NNEUR}]", f"data.ncol={NCOL}",
                       f"data.h5_path={data}", f"grid_path={grid}"]}


def test_option_cli_matches_jax(files, tmp_path, monkeypatch):
    """One epoch of 6 fused updates with 16-wide sweeps on 32 columns."""
    common = files["common"] + ["epochs=1"] + OPTIONS
    jlog, tlog = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    first = {}
    init = jrollout.RolloutTrainer.init

    def keep_init(self, *a, **k):
        params, *rest = init(self, *a, **k)
        # a copy: the training step donates the arrays it is given
        first["params"] = jax.tree_util.tree_map(np.array, params)
        return (params, *rest)

    monkeypatch.setattr(jrollout.RolloutTrainer, "init", keep_init)
    with jax.enable_x64(False):
        assert jax_main([GRU, "platform=cpu", f"log_path={jlog}"]
                        + common) == 0
    run = cli.setup(load_config(GRU, common + ["device=cpu"]))
    w0 = str(tmp_path / "w0.pt")
    torch.save(from_flax_params(first["params"], run.trainer.model), w0)
    assert cli.main([GRU, "device=cpu", f"init_from={w0}",
                     f"log_path={tlog}"] + common) == 0
    (w,), (g,) = read_log(jlog), read_log(tlog)
    assert set(g) == set(w)
    for k in ("epoch", "window", "mix_frac", "updates", "dispatches"):
        assert g[k] == w[k], k
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
