"""The offline CLI's cloud-state classifier arms (``cli/train_offline.py::
train_classifier``: ``classifier`` and ``classifier_gradout``) against
JAX's ``train_classifier``, called in-process on the same arrays on the
CPU: the port's ``setup`` builds the v5 data (``conf/mlp_v1.yaml`` at 6
steps, batch 384: 4 updates an epoch and 2 validation batches) and the
labels, and both start from the flax parameters JAX's ``init`` gives the
narrow U-Net (16 channels, 1 block, two levels) for the CLI's seed. Every
record's entries (train_ce, val_ce, and for gradout the gradient
statistics, under global-norm clipping at 1.0) within rtol 1e-5, and the
accuracy line's within 1e-4 (the float32 chain in another order). Then
the port's checkpoint and ``init_from``. JAX runs with x64 off, as its
CLI does."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu import variables as JV
from climsim_tpu.cli import train_offline as jax_cli
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.models.unet import ClimsimUNetClassifier as JaxClassifier
from climsim_tpu.train import FitConfig as JaxFitConfig
from climsim_tpu_torch.cli import train_offline as cli
from climsim_tpu_torch.data import synthetic as S
from climsim_tpu_torch.models import from_flax_params
from climsim_tpu_torch.train.config import load_config
from test_torch_train_cli import REPO, write_grid

MLP = os.path.join(REPO, "conf", "mlp_v1.yaml")
NARROW = ["model.model_channels=16", "model.num_blocks=1",
          "model.channel_mult=[1,2]"]
COMMON = ["device=cpu", "vset=v5", "data.steps=6", "batch_size=384",
          "epochs=2"] + NARROW


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cls") / "grid.nc")
    write_grid(path, 384)
    return path


def lines_of(out):
    recs = [json.loads(ln) for ln in out if ln.startswith('{"epoch"')]
    acc = [json.loads(ln) for ln in out if ln.startswith('{"val_accuracy"')]
    return recs, acc


@pytest.mark.parametrize("name,over", [
    ("classifier", []),
    ("classifier_gradout", ["optimizer.max_grad_norm=1.0"])])
def test_train_classifier_matches_jax(name, over, grid, capsys):
    cfg = load_config(MLP, COMMON + [f"model.name={name}",
                                     f"grid_path={grid}"] + over)
    run = cli.setup(cfg)
    # JAX's arguments: the normalized registry inputs (before the U-Net's
    # remap) and the raw series, as the JAX CLI passes them
    xs, ys = S.make_timeseries(torch.Generator().manual_seed(0),
                               S.SyntheticConfig(vset_name="v5"), run.grid, 6)
    x_raw = xs.reshape(len(run.x), -1)
    assert torch.equal(x_raw, run.x)
    xn = run.nz.normalize_input(x_raw).numpy()
    y_raw = ys.reshape(len(run.x), -1).numpy()
    with jax.enable_x64(False):
        params = jax.jit(JaxClassifier(
            num_vars_profile=run.vset.inputs.n_lev_vars,
            num_vars_scalar=run.vset.inputs.n_sfc_vars,
            model_channels=16, channel_mult=(1, 2), num_blocks=1).init)(
                jax.random.PRNGKey(0), jnp.asarray(run.xn[:2].numpy()))
        run.model.load_state_dict(from_flax_params(
            jax.tree_util.tree_map(np.asarray, params), run.model))
        assert jax_cli.train_classifier(
            cfg.to_dict(), JV.get("v5"), JaxGrid.from_file(grid), xn,
            x_raw.numpy(), y_raw, run.ntr,
            JaxFitConfig(lr=1e-3, epochs=2, batch_size=384,
                         max_grad_norm=run.fc.max_grad_norm),
            gradout=name == "classifier_gradout") == 0
        want, want_acc = lines_of(capsys.readouterr().out.splitlines())
    assert cli.train_classifier(run, gradout=name == "classifier_gradout") \
        == 0
    got, got_acc = lines_of(capsys.readouterr().out.splitlines())
    assert [r["epoch"] for r in got] == [0, 1]
    keys = {"epoch", "train_ce", "val_ce"}
    if name == "classifier_gradout":
        keys |= {"max_grad", "mean_grad_l2", "total_norm"}
    for g, w in zip(got, want):
        assert set(g) == set(w) == keys
        for k in keys - {"epoch"}:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    (g,), (w,) = got_acc, want_acc
    assert set(g["per_class"]) == set(w["per_class"])
    np.testing.assert_allclose(g["val_accuracy"], w["val_accuracy"],
                               atol=1e-4)
    for c in w["per_class"]:
        np.testing.assert_allclose(g["per_class"][c], w["per_class"][c],
                                   atol=1e-4)


def test_classifier_checkpoint_and_init_from(grid, tmp_path, capsys):
    """classifier_gradout with checkpoint_dir writes classifier.pt; a run
    with init_from that directory loads every tensor, keeps none, and its
    first train_ce lies below the cold start's."""
    base = [MLP] + COMMON + ["model.name=classifier_gradout",
                             f"grid_path={grid}",
                             "optimizer.max_grad_norm=1.0"]
    ck = str(tmp_path / "ck")
    assert cli.main(base + [f"checkpoint_dir={ck}"]) == 0
    cold, _ = lines_of(capsys.readouterr().out.splitlines())
    assert os.path.exists(os.path.join(ck, cli.CLASSIFIER_FILE))
    assert cli.main(base + [f"init_from={ck}", "epochs=1"]) == 0
    out = capsys.readouterr().out.splitlines()
    n = len(cli.setup(load_config(base[0], base[1:])).model.state_dict())
    assert f"init_from: loaded {n} tensors, kept 0" in out
    warm, acc = lines_of(out)
    assert len(warm) == 1 and len(acc) == 1
    assert warm[0]["train_ce"] < cold[0]["train_ce"]
