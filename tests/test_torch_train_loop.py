"""The port's offline training loop (``climsim_tpu_torch/train/loop.py``)
against the JAX package's (``climsim_tpu/train/loop.py``) on the CPU.

Each case runs JAX's ``fit`` one epoch from its initial state, carries
the parameters and the optax Adam state (moments and count; the injected
learning rate under the plateau rule) across with ``from_flax_params``
and ``from_optax_adam``, and then both packages ``fit`` 2 more epochs on
the same batches: adam, adamw, global-norm clipping, each schedule, the
plateau rule, early stopping and the NaN abort (a poisoned batch). The
records' losses agree within rtol 1e-4 and the parameters after the run
within rtol 3e-4 and atol 1e-6: JAX's own tolerances for its fused
against its sharded epoch (tests/test_rnn.py:494-496); XLA and torch sum
in other orders, and Adam's division by sqrt(nu) + eps carries that
rounding into every update. The checkpoint round trip is the port's
alone. JAX runs with x64 off, as its CLI does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu import variables as JV
from climsim_tpu.models import mlp_for as jax_mlp_for
from climsim_tpu.train import FitConfig as JaxFitConfig
from climsim_tpu.train import fit as jax_fit
from climsim_tpu.train import init_state as jax_init_state
from climsim_tpu_torch import variables as V
from climsim_tpu_torch.models import (from_flax_params, from_optax_adam,
                                      mlp_for)
from climsim_tpu_torch.train import loop

FEATURES, BATCH, NB = (32, 24), 16, 4
RTOL_LOSS, RTOL_P, ATOL_P = 1e-4, 3e-4, 1e-6

CASES = {
    "adam": dict(loss="huber"),
    "adamw": dict(optimizer="adamw", weight_decay=1e-2, loss="mse"),
    "clip": dict(max_grad_norm=0.05, loss="mae"),
    "cosine": dict(lr_schedule="cosine", schedule_steps=10, warmup_steps=3,
                   min_lr=1e-4),
    "onecycle": dict(lr_schedule="onecycle", schedule_steps=12),
    "step": dict(lr_schedule="step", decay_every=3, lr_gamma=0.5),
    "warmup": dict(lr_schedule="warmup", warmup_steps=6),
    "plateau": dict(plateau_patience=1, plateau_factor=0.5, min_lr=2e-3,
                    lr=1e-2),
    "early_stop": dict(early_stop_patience=1, epochs=3, lr=1e-2),
    "var_weights": dict(var_weights={"ptend_t": 3.0, "cam_out_PRECC": 0.5}),
}
# the cases whose validation target is the train target negated, so that
# training makes the validation loss worse: plateau and early stop fire
WORSENING = ("plateau", "early_stop")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def batches(seed=0, poison=False, negate_val=False):
    """NB train batches and 2 validation batches of v1 (x [16, 124],
    y [16, 128]); y a smooth function of x."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.2, (124, 128)).astype(np.float32)
    def one(n):
        x = rng.normal(0, 1, (n, 124)).astype(np.float32)
        return x, np.tanh(x @ w).astype(np.float32)
    train = [one(BATCH) for _ in range(NB)]
    val = [one(BATCH) for _ in range(2)]
    if negate_val:
        val = [(x, -y) for x, y in val]
    if poison:
        x, y = train[1]
        x = x.copy()
        x[3, 5] = np.nan
        train[1] = (x, y)
    return train, val


def adam_state(opt_state):
    """The ScaleByAdamState (count, mu, nu) inside an optax state, and
    the injected learning rate where there is one."""
    found, lr = [], []

    def walk(s):
        if hasattr(s, "mu") and hasattr(s, "nu") and hasattr(s, "count"):
            found.append(s)
            return
        hp = getattr(s, "hyperparams", None)
        if isinstance(hp, dict) and "learning_rate" in hp:
            lr.append(float(hp["learning_rate"]))
        if isinstance(s, tuple):
            for c in s:
                walk(c)
    walk(opt_state)
    assert len(found) == 1
    return found[0], (lr[0] if lr else None)


def carried(jstate, cfg):
    """The port's model and TrainState holding JAX's parameters and Adam
    state."""
    tm = mlp_for(V.get("v1"), FEATURES, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tm.load_state_dict(from_flax_params(params, tm))
    state = loop.init_state(tm, cfg)
    adam, lr = adam_state(jstate.opt_state)
    count = int(adam.count)
    state.opt.load_state_dict(from_optax_adam(
        jax.tree_util.tree_map(np.asarray, adam.mu),
        jax.tree_util.tree_map(np.asarray, adam.nu), count, tm, state.opt))
    if lr is not None:
        for g in state.opt.param_groups:
            g["lr"] = lr
    state.step = count
    return tm, state


def both(case, epochs=2, poison=False):
    """JAX: 1 epoch from its init, then `epochs` more; the port: the same
    `epochs` from the carried state. Returns (jax history, port history,
    jax params, port model) or the exceptions each raised."""
    over = dict(CASES[case])
    epochs = over.pop("epochs", epochs)
    train, val = batches(poison=poison, negate_val=case in WORSENING)
    tb, vb = (lambda: train), (lambda: val)
    jvs = JV.get("v1")
    with jax.enable_x64(False):
        jcfg = JaxFitConfig(epochs=1, batch_size=BATCH, **over)
        jm = jax_mlp_for(jvs, FEATURES)
        js = jax_init_state(jm, jvs, jcfg, jnp.asarray(train[0][0][:2]))
        clean, _ = batches()
        js, _ = jax_fit(jm, jvs, jcfg, lambda: clean, lambda: val, state=js)
        tm, ts = carried(js, loop.FitConfig(epochs=epochs, batch_size=BATCH,
                                            **over))
        jcfg.epochs = epochs
        try:
            js, jh = jax_fit(jm, jvs, jcfg, tb, vb, state=js)
        except FloatingPointError as e:
            jh = e
    try:
        ts, th = loop.fit(tm, V.get("v1"), loop.FitConfig(
            epochs=epochs, batch_size=BATCH, **over), tb, vb, state=ts)
    except FloatingPointError as e:
        th = e
    return jh, th, js, tm


def check_records(jh, th):
    assert len(jh) == len(th)
    for j, t in zip(jh, th):
        assert set(j) == set(t), (j, t)
        for k in ("train_loss", "val_loss", "val_r2"):
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL_LOSS,
                                       err_msg=k)
        for k in ("epoch", "lr_reduced", "early_stop"):
            assert t.get(k) == j.get(k), k


def check_params(js, tm):
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(js.params["params"], "")
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), flat[name], rtol=RTOL_P,
                                   atol=ATOL_P, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_jax(case):
    jh, th, js, tm = both(case)
    check_records(jh, th)
    check_params(js, tm)
    if case == "plateau":
        assert any(r.get("lr_reduced") for r in jh)
    if case == "early_stop":
        assert jh[-1].get("early_stop") and len(jh) < 3


def test_nan_abort_matches_jax():
    """A NaN in one batch makes every later loss NaN: with nan_strikes 2
    both abort at the second epoch; with 3 both return their NaN
    records."""
    jh, th, _, _ = both("adam", poison=True)
    assert isinstance(jh, FloatingPointError)
    assert isinstance(th, FloatingPointError) and str(th) == str(jh)
    CASES["nan_kept"] = dict(nan_strikes=3)
    try:
        jh, th, _, _ = both("nan_kept", poison=True)
    finally:
        del CASES["nan_kept"]
    assert len(jh) == len(th) == 2
    for j, t in zip(jh, th):
        assert np.isnan(j["train_loss"]) and np.isnan(t["train_loss"])


def test_unported_and_refused_optimizers():
    """soap and muon raise naming A.13; the plateau rule refuses a
    schedule and another optimizer, as JAX's make_optimizer does."""
    tm = mlp_for(V.get("v1"), FEATURES, device="cpu")
    for name in ("soap", "muon"):
        with pytest.raises(NotImplementedError, match="A.13"):
            loop.init_state(tm, loop.FitConfig(optimizer=name))
    with pytest.raises(ValueError, match="plateau excludes"):
        loop.init_state(tm, loop.FitConfig(plateau_patience=1,
                                           lr_schedule="cosine"))
    with pytest.raises(ValueError, match="plateau supports"):
        loop.init_state(tm, loop.FitConfig(plateau_patience=1,
                                           optimizer="soap"))


def test_fit_config_takes_no_seed():
    """The initial parameters come from the model's constructor: a
    FitConfig seed, which JAX's init_state reads, is refused, not
    ignored."""
    with pytest.raises(TypeError, match="seed"):
        loop.FitConfig(seed=3)


def test_clip_by_global_norm_matches_optax():
    """Below, at and above the norm: optax's clip_by_global_norm."""
    import optax
    rng = np.random.default_rng(1)
    gs = [rng.normal(0, 1, s).astype(np.float32) for s in ((3, 4), (5,))]
    norm = float(np.sqrt(sum((g ** 2).sum() for g in gs)))
    for max_norm in (norm * 2, norm, norm / 3):
        with jax.enable_x64(False):
            want, _ = optax.clip_by_global_norm(max_norm).update(
                [jnp.asarray(g) for g in gs], None)
        got = [torch.tensor(g) for g in gs]
        loop.clip_by_global_norm_(got, max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_checkpoint_round_trip(tmp_path):
    """fit saves the best epoch; restoring it into a fresh model and
    optimizer gives the same parameters, optimizer state and update
    count, and the next epoch from either is the same."""
    train, val = batches()
    cfg = loop.FitConfig(epochs=2, batch_size=BATCH)
    vs = V.get("v1")
    tm = mlp_for(vs, FEATURES, device="cpu", seed=3)
    state, hist = loop.fit(tm, vs, cfg, lambda: train, lambda: val,
                           checkpoint_dir=str(tmp_path))
    assert hist[1]["val_loss"] < hist[0]["val_loss"]
    assert (tmp_path / "latest.txt").read_text() == "ep1"
    fresh = loop.init_state(mlp_for(vs, FEATURES, device="cpu", seed=9),
                            cfg)
    fresh, epoch = loop.restore_checkpoint(str(tmp_path), fresh)
    assert epoch == 1 and fresh.step == state.step == 2 * NB
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    cfg1 = loop.FitConfig(epochs=1, batch_size=BATCH)
    _, h_a = loop.fit(state.model, vs, cfg1, lambda: train, state=state)
    _, h_b = loop.fit(fresh.model, vs, cfg1, lambda: train, state=fresh)
    assert h_a[0]["train_loss"] == h_b[0]["train_loss"]
