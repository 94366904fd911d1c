"""The port's weighted scoreboard (``climsim_tpu_torch/metrics``) against
the JAX package's (``climsim_tpu/metrics``) on the CPU, on a seeded
[T, 384, ny] prediction and target of v1 and of v4_rnn with raw surface
pressure: ``weight_outputs``, the estimators, ``crps``, ``evaluate`` (with
and without samples) and ``per_level_table`` at rtol 1e-5 (the float32
chain in another order; each array also gets an absolute floor of 1e-6
of its largest magnitude, since a bias or an R2 near zero carries no
relative precision). Then the plots, and the rollout CLI's
``plots_dir``. JAX runs with x64 off, as its CLIs run it."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu import metrics as JM
from climsim_tpu import variables as JV
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu_torch import Grid
from climsim_tpu_torch import metrics as TM
from climsim_tpu_torch import variables as V
from climsim_tpu_torch.metrics import plots

T, NCOL, S = 3, 384, 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=1e-5, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def arrays(vset_name, seed=0):
    """Scaled target ~ N(0, 1), prediction = 0.8 target + N(0, 0.4),
    samples = prediction + N(0, 0.3) each, raw ps in [9.6e4, 1.03e5] Pa,
    and a positive output scale."""
    ny = V.get(vset_name).target_feature_len
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    target = f(rng.normal(0, 1, (T, NCOL, ny)))
    pred = f(0.8 * target + rng.normal(0, 0.4, target.shape))
    samples = f(pred[..., None] + rng.normal(0, 0.3, target.shape + (S,)))
    ps = f(rng.uniform(9.6e4, 1.03e5, (T, NCOL)))
    scale = f(10.0 ** rng.uniform(-2, 6, ny))
    return pred, target, samples, ps, scale


def port(*arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("vset", ["v1", "v4_rnn"])
@pytest.mark.parametrize("scaled", [True, False])
def test_weight_outputs_matches_jax(vset, scaled):
    pred, _, _, ps, scale = arrays(vset)
    grid = Grid.synthetic(NCOL)
    got = TM.weight_outputs(*port(pred, ps), V.get(vset), grid,
                            torch.as_tensor(scale) if scaled else None)
    with jax.enable_x64(False):
        want = JM.weight_outputs(jnp.asarray(pred), jnp.asarray(ps),
                                 JV.get(vset), JaxGrid.synthetic(NCOL),
                                 jnp.asarray(scale) if scaled else None)
    assert got.dtype == torch.float32
    close(got.numpy(), want)
    split = TM.split_variables(got, V.get(vset))
    jsplit = JM.split_variables(want, JV.get(vset))
    assert list(split) == list(jsplit)
    for k in split:
        assert tuple(split[k].shape) == jsplit[k].shape


@pytest.mark.parametrize("avg_grid", [True, False])
def test_estimators_match_jax(avg_grid):
    pred, target, samples, _, _ = arrays("v1")
    p, t, s = pred[..., :60], target[..., :60], samples[..., :60, :]
    with jax.enable_x64(False):
        for name in ("mae", "rmse", "r2", "bias"):
            close(getattr(TM, name)(*port(p, t), avg_grid=avg_grid).numpy(),
                  getattr(JM, name)(jnp.asarray(p), jnp.asarray(t),
                                    avg_grid=avg_grid), err_msg=name)
        close(TM.crps(*port(s, t), avg_grid=avg_grid).numpy(),
              JM.crps(jnp.asarray(s), jnp.asarray(t), avg_grid=avg_grid))
        close(TM.recover_ps(torch.as_tensor(pred), V.get("v1"), 9.8e4, 1e4)
              .numpy(), JM.recover_ps(jnp.asarray(pred), JV.get("v1"), 9.8e4,
                                      1e4))


@pytest.mark.parametrize("vset", ["v1", "v4_rnn"])
@pytest.mark.parametrize("with_samples", [False, True])
def test_evaluate_matches_jax(vset, with_samples):
    """The frames: same index and columns (CRPS with samples), values at
    rtol 1e-5 column by column."""
    pred, target, samples, ps, scale = arrays(vset)
    sp = samples if with_samples else None
    got = TM.evaluate(*port(pred, target, ps), V.get(vset),
                      Grid.synthetic(NCOL), scale=torch.as_tensor(scale),
                      samplepreds=None if sp is None else torch.as_tensor(sp))
    with jax.enable_x64(False):
        want = JM.evaluate(jnp.asarray(pred), jnp.asarray(target),
                           jnp.asarray(ps), JV.get(vset),
                           JaxGrid.synthetic(NCOL),
                           scale=jnp.asarray(scale),
                           samplepreds=None if sp is None else
                           jnp.asarray(sp))
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        close(got[c].to_numpy(), want[c].to_numpy(), err_msg=c)


@pytest.mark.parametrize("vset", ["v1", "v4_rnn"])
def test_per_level_table_matches_jax(vset):
    pred, target, _, ps, scale = arrays(vset, seed=1)
    got = TM.per_level_table(*port(pred, target, ps), V.get(vset),
                             Grid.synthetic(NCOL),
                             scale=torch.as_tensor(scale))
    with jax.enable_x64(False):
        want = JM.per_level_table(jnp.asarray(pred), jnp.asarray(target),
                                  jnp.asarray(ps), JV.get(vset),
                                  JaxGrid.synthetic(NCOL),
                                  scale=jnp.asarray(scale))
    assert list(got.columns) == list(want.columns)
    assert got.shape == want.shape == (60, 4 * len(
        V.get(vset).outputs.lev_names))
    for c in want.columns:
        close(got[c].to_numpy(), want[c].to_numpy(), err_msg=str(c))


def test_scoreboard_needs_no_pandas(monkeypatch):
    """scoreboard and level_metrics return plain dicts with pandas
    absent; evaluate and per_level_table raise ImportError then."""
    import sys
    pred, target, _, ps, scale = arrays("v1")
    args = (*port(pred, target, ps), V.get("v1"), Grid.synthetic(NCOL))
    monkeypatch.setitem(sys.modules, "pandas", None)
    board = TM.scoreboard(*args, scale=torch.as_tensor(scale))
    assert list(board) == list(V.get("v1").outputs.names)
    assert all(set(r) == {"MAE", "RMSE", "R2", "bias"}
               for r in board.values())
    lev = TM.level_metrics(*args)
    assert set(lev) == {(n, k) for n in ("ptend_t", "ptend_q0001")
                        for k in ("MAE", "RMSE", "R2", "bias")}
    with pytest.raises(ImportError):
        TM.evaluate(*args)
    with pytest.raises(ImportError):
        TM.per_level_table(*args)


def test_plots_write_files(tmp_path):
    """Each plot writes its PNG; tensors and numpy arrays are taken."""
    pred, target, _, _, _ = arrays("v1")
    p = plots.profile_plot({"a": torch.linspace(0, 1, 60),
                            "b": np.linspace(1, 0, 60)},
                           pressure=np.linspace(1e3, 1e5, 60),
                           save_path=str(tmp_path / "profile.png"))
    z = plots.zonal_mean_bias(torch.as_tensor(pred[..., :60]),
                              target[..., :60], np.linspace(-88, 88, NCOL),
                              save_path=str(tmp_path / "zonal.png"))
    c = plots.training_curves([{"train_loss": 1.0, "val_loss": 2.0},
                               {"train_loss": 0.5, "val_loss": 1.0}],
                              save_path=str(tmp_path / "curves.png"))
    for path in (p, z, c):
        assert os.path.getsize(path) > 1000


def test_train_rollout_plots_dir(tmp_path):
    """``plots_dir`` with ``eval_report`` writes val_r2_profile.png, as
    the JAX CLI does (climsim_tpu/cli/train_rollout.py:608-621)."""
    from climsim_tpu_torch.cli import train_rollout as cli
    from test_torch_train_cli import GRU, write_grid
    grid = str(tmp_path / "grid.nc")
    write_grid(grid)
    rc = cli.main([GRU, "device=cpu", f"grid_path={grid}", "epochs=1",
                   "model.nneur=[8,8]", "data.ncol=32", "data.steps=6",
                   "eval_report=true", f"plots_dir={tmp_path / 'plots'}"])
    assert rc == 0
    assert os.path.getsize(tmp_path / "plots" / "val_r2_profile.png") > 1000
