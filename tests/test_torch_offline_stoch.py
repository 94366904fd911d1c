"""The offline CLI's stochastic arms (``cli/train_offline.py::
train_stochastic``: HSR, RPN, cVAE) against JAX's ``train_stochastic``,
called in-process on the same arrays on the CPU: the port's ``setup``
builds the data (``conf/mlp_v1.yaml`` at 6 steps, narrow models, 3
epochs so that HSR's warm phase ends after the first), both start from
the flax parameters JAX's own ``init`` gives for the CLI's seed, and the
port is fed JAX's threefry draws (the cVAE's eps at each update, its z
and eps at sampling, HSR's eps at sampling) through ``noise_source``,
replaying JAX's key splits. Every epoch's train_loss within rtol 1e-5
and every scoreboard entry (MAE, RMSE, R2, bias, CRPS) within rtol 1e-4
of JAX's unrounded frame (the float32 chain summed in other orders; R2's
infinities where a target is constant must match). JAX runs with x64
off, as its CLI does."""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climsim_tpu.metrics as jax_metrics
import climsim_tpu_torch.metrics as port_metrics
from climsim_tpu import models as JM
from climsim_tpu import variables as JV
from climsim_tpu.cli import train_offline as jax_cli
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.train import FitConfig as JaxFitConfig
from climsim_tpu_torch.cli import train_offline as cli
from climsim_tpu_torch.models import from_flax_params
from climsim_tpu_torch.train.config import load_config
from test_torch_train_cli import REPO, write_grid

MLP = os.path.join(REPO, "conf", "mlp_v1.yaml")
EPOCHS, SAMPLES = 3, 4
ARMS = {"hsr": ["model.hidden=32", "model.layers=2"],
        "rpn": ["model.features=[32,32]", "model.members=4"],
        "cvae": ["model.hidden=32", "model.latent_dim=3",
                 "model.beta=0.5"]}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stoch") / "grid.nc")
    write_grid(path, 384)
    return path


def jax_init(name, cfg, xn, yn):
    """JAX's initial parameters as its ``train_stochastic`` makes them."""
    m, ny = cfg["model"], yn.shape[1]
    key = jax.random.PRNGKey(cfg.get("seed", 0))
    if name == "hsr":
        return JM.HSR(out_dim=ny, hidden=m["hidden"], layers=m["layers"]) \
            .init(key, jnp.asarray(xn[:2]))
    if name == "rpn":
        return JM.RPNEnsemble(out_dim=ny, features=tuple(m["features"]),
                              num_members=m["members"]) \
            .init(key, jnp.asarray(xn[:2]))
    return JM.CVAE(out_dim=ny, latent_dim=m["latent_dim"], hidden=m["hidden"],
                   layers=2).init(key, jnp.asarray(yn[:2]),
                                  jnp.asarray(xn[:2]), key)


class JaxDraws:
    """``noise_source`` replaying JAX's draws: its epoch keys split from
    PRNGKey(seed), a batch key split from each, and the sampling key
    after the last epoch, as ``train_stochastic`` splits them."""

    def __init__(self, name, seed, epochs, n_batches, batch, latent, nval,
                 ny, S):
        normal = lambda k, s: np.asarray(jax.random.normal(k, s,
                                                           jnp.float32))
        self.queue = []
        key = jax.random.PRNGKey(seed)
        for _ in range(epochs):
            key, ke = jax.random.split(key)
            for _ in range(n_batches):
                ke, kb = jax.random.split(ke)
                if name == "cvae":
                    self.queue.append(("update", normal(kb, (batch, latent))))
        key, ks = jax.random.split(key)
        if name == "hsr":
            self.queue.append(("sample_eps", normal(ks, (nval, ny, S))))
        elif name == "cvae":
            zs, es = [], []
            for k in jax.random.split(ks, S):
                kz, ke = jax.random.split(k)
                zs.append(normal(kz, (nval, latent)))
                es.append(normal(ke, (nval, ny)))
            self.queue += [("sample_z", np.stack(zs)),
                           ("sample_eps", np.stack(es))]

    def __call__(self, what, shape):
        want, a = self.queue.pop(0)
        assert what == want and a.shape == tuple(shape), (what, shape)
        return torch.tensor(a)


def capture(module, frames):
    """Wrap ``module.evaluate`` to keep each frame it returns."""
    orig = module.evaluate

    def evaluate(*args, **kw):
        frames.append(orig(*args, **kw))
        return frames[-1]
    return evaluate


@pytest.mark.parametrize("name", list(ARMS))
def test_train_stochastic_matches_jax(name, grid, capsys, monkeypatch):
    over = ["device=cpu", f"grid_path={grid}", "data.steps=6",
            f"epochs={EPOCHS}", f"model.name={name}",
            f"num_crps_samples={SAMPLES}"] + ARMS[name]
    cfg = load_config(MLP, over)
    run = cli.setup(cfg)
    xn, yn, x = (t.numpy() for t in (run.xn, run.yn, run.x))
    jcfg = cfg.to_dict()
    with jax.enable_x64(False):
        run.model.load_state_dict(from_flax_params(
            jax.tree_util.tree_map(np.asarray,
                                   jax_init(name, jcfg, xn, yn)), run.model))
        jframes, tframes = [], []
        monkeypatch.setattr(jax_metrics, "evaluate",
                            capture(jax_metrics, jframes))
        assert jax_cli.train_stochastic(
            name, jcfg, JV.get("v1"), JaxGrid.from_file(grid), xn, yn, x,
            types.SimpleNamespace(scale=jnp.asarray(run.nz.scale.numpy())),
            run.ntr, JaxFitConfig(lr=1e-3, epochs=EPOCHS,
                                  batch_size=1536)) == 0
        jlines = capsys.readouterr().out.splitlines()
        nval = (len(xn) - run.ntr) // 384 * 384
        draws = JaxDraws(name, 0, EPOCHS, run.ntr // 1536, 1536,
                         jcfg["model"].get("latent_dim", 5), nval,
                         yn.shape[1], SAMPLES)
    monkeypatch.setattr(port_metrics, "evaluate",
                        capture(port_metrics, tframes))
    assert cli.train_stochastic(run, noise_source=draws) == 0
    tlines = capsys.readouterr().out.splitlines()
    assert not draws.queue
    recs = lambda lines: [json.loads(ln) for ln in lines
                          if ln.startswith('{"epoch"')]
    want, got = recs(jlines), recs(tlines)
    assert [r["epoch"] for r in got] == list(range(EPOCHS))
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"epoch", "train_loss"}
        np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                   rtol=1e-5)
    (jf,), (tf,) = jframes, tframes
    assert list(tf.index) == list(jf.index)
    assert list(tf.columns) == list(jf.columns) == ["MAE", "RMSE", "R2",
                                                    "bias", "CRPS"]
    np.testing.assert_allclose(tf.to_numpy(float), jf.to_numpy(float),
                               rtol=1e-4)
    # the printed table is the frame rounded to 4 decimals
    table = tf.round(4).to_string().splitlines()
    assert tlines[-len(table):] == table
    assert [r["epoch"] for r in run.history] == list(range(EPOCHS))
    assert all(r["seconds"] > 0 for r in run.history)
