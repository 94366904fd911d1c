"""Ensemble (stochastic) rollout training: the port's ``RolloutTrainer``
with ``ensemble_size`` > 1 against the JAX package's, on the CPU, with the
stochastic ``RNNAutoreg`` on the same flax parameters and the same noise.

JAX draws member m's noise at the window's step s from
``split(fold_in(PRNGKey(seed), s), M)[m]`` (threefry); the port's draws
come from its ``noise_source``, which here replays JAX's draw for each
(s, m), read from a twin of the model with ``ar_noise_rho > 0`` (it
returns the fresh draw as its fourth output). For each case: one window's
loss (1e-5 relative) and parameter gradients (1e-4 relative, plus 1e-4 of
the leaf's largest, plus 4x the movement of JAX's own gradient when every
parameter moves by 1e-6 relative: the variogram score's
|a - b|^-0.5 derivative turns rounding into up to 1e-3 relative where
two features are close), and the parameters after one optimizer
update."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models.rnn import RNNAutoreg as JaxRNNAutoreg
from climsim_tpu.train.rollout import (RolloutConfig as JaxConfig,
                                       RolloutTrainer as JaxTrainer)
from climsim_tpu_torch.models import RNNAutoreg, from_flax_params
from climsim_tpu_torch.train import RolloutConfig, RolloutTrainer
from climsim_tpu_torch.train.rollout import KeyedNoise

NX, NX_SFC, NY, NY_SFC = 6, 24, 6, 8
NNEUR, NH_MEM, L, B, W, M = (12, 12), 4, 10, 5, 3, 3
HYAI = np.linspace(2e-3, 0.0, L + 1).astype(np.float32)
HYBI = np.linspace(0.0, 1.0, L + 1).astype(np.float32)

CASES = {
    "crps": dict(),
    "crps_af": dict(cfg=dict(ens_loss="crps_af", ens_beta=1.2)),
    "crps_sorted": dict(cfg=dict(ens_loss="crps_sorted")),
    "energy": dict(cfg=dict(ens_loss="energy")),
    "variogram": dict(cfg=dict(ens_loss="variogram")),
    "ds": dict(cfg=dict(ens_loss="ds")),
    "sumvar": dict(cfg=dict(ens_sumvar=True)),
    "start_before": dict(cfg=dict(crps_start_epoch=2), epoch=1),
    "start_after": dict(cfg=dict(crps_start_epoch=2), epoch=2),
    "w_det": dict(cfg=dict(w_det=0.7)),
    "rho0": dict(model=dict(ar_noise_rho=0.0)),
    "slstm_shared": dict(model=dict(stochastic_cell="slstm",
                                    ar_noise_vertical=False)),
    "remat_replay": dict(cfg=dict(remat=True, replay="full",
                                  replay_slice=(0, 3), pred_slice=(0, 3))),
}


def _data(T=W, seed=3):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(0, 0.3, s).astype(np.float32)
    return {"x_lev": r(T, B, L, NX), "x_sfc": r(T, B, NX_SFC),
            "y_lev": r(T, B, L, NY), "y_sfc": r(T, B, NY_SFC),
            "sp": (1e5 + 1e3 * rng.standard_normal((T, B))).astype(
                np.float32)}


def _model_kw(over):
    kw = dict(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=NNEUR,
              nh_mem=NH_MEM, add_pres=False, add_stochastic_layer=True,
              ar_noise_rho=0.9)
    kw.update(over)
    return kw


# JAX's draws by (vertical, width, seed, M, step, member, shape): a draw
# depends on the key and the shape only
_DRAWS: dict = {}


class JaxDraws:
    """``noise_source`` replaying JAX's trainer draws: member m at the
    window's step s draws under split(fold_in(PRNGKey(seed), s), M)[m]."""

    def __init__(self, kw, params, seed, M):
        self.twin = JaxRNNAutoreg(**{**kw, "ar_noise_rho": 0.5})
        self.params, self.seed, self.M = params, seed, M
        self.tag = (kw.get("ar_noise_vertical", True), kw["nneur"][-1])
        self.calls = []

    def key(self, s, m):
        return jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(self.seed), s), self.M)[m]

    def __call__(self, s, m, shape):
        self.calls.append((s, m))
        k = self.tag + (self.seed, self.M, s, m, tuple(shape))
        if k not in _DRAWS:
            _, Bg, _ = shape
            z = lambda *sh: jnp.zeros(sh, jnp.float32)
            with jax.enable_x64(False):
                eps = self.twin.apply(
                    self.params, z(Bg, L, NX), z(Bg, NX_SFC),
                    z(Bg, L, NH_MEM), deterministic=False,
                    rngs={"noise": self.key(s, m)})[3]
            assert tuple(eps.shape) == tuple(shape)
            _DRAWS[k] = torch.tensor(np.array(eps))
        return _DRAWS[k].clone()


def _setup(case):
    spec = CASES[case]
    kw = _model_kw(spec.get("model", {}))
    cfg = dict(ensemble_size=M, loss="huber", lr=1e-3, seed=4,
               rollout_schedule={0: W})
    cfg.update(spec.get("cfg", {}))
    with jax.enable_x64(False):
        jm = JaxRNNAutoreg(**kw)
        jt = JaxTrainer(jm, JaxConfig(**cfg), HYAI, HYBI)
        params, opt_state, mem = jt.init(
            jax.random.PRNGKey(0), {k: jnp.asarray(v)
                                    for k, v in _data().items()})
    tm = RNNAutoreg(device="cpu", **kw)
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    # a copy: the JAX update donates its parameters
    draws = JaxDraws(kw, jax.tree_util.tree_map(np.array, params),
                     cfg["seed"], M)
    tt = RolloutTrainer(tm, RolloutConfig(**cfg), HYAI, HYBI, device="cpu",
                        noise_source=draws)
    epoch = spec.get("epoch", 0)
    jt._set_epoch_state(epoch)
    tt._set_epoch_state(epoch)
    return jt, params, opt_state, mem, tt, draws


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_ensemble_window_matches_jax(case):
    jt, params, opt_state, mem0, tt, draws = _setup(case)
    data = _data()
    window = {k: jnp.asarray(v) for k, v in data.items()}
    twin = {k: torch.tensor(v) for k, v in data.items()}
    # a memory that is not zero, different per member
    m0 = np.random.default_rng(8).normal(0, 0.5, (M, B, L, NH_MEM)).astype(
        np.float32)
    mask = jnp.ones((B,), jnp.float32)
    with jax.enable_x64(False):
        grad = jax.value_and_grad(
            lambda p, m: jt._window_loss(p, window, m, mask), has_aux=True)
        (jloss, jmem), jgrad = grad(params, jnp.asarray(m0))
        moved = jax.tree_util.tree_map(lambda a: a * (1 + 1e-6), params)
        witness = _flat(grad(moved, jnp.asarray(m0))[1]["params"])
    tt.opt.zero_grad(set_to_none=True)
    tloss, tmem = tt._window_loss(twin, torch.tensor(m0), None)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert tmem.shape == (M, B, L, NH_MEM)
    np.testing.assert_allclose(tmem.detach().numpy(), np.asarray(jmem),
                               rtol=1e-5, atol=1e-6)
    # every (step, member) drew once in the forward (the remat recompute
    # reuses the draws)
    assert sorted(draws.calls) == [(s, m) for s in range(W)
                                   for m in range(M)]
    # the variogram score's |a - b|^0.5 has a NaN gradient where both
    # features are 0, as the output prune makes them in the top levels:
    # NaN in JAX's gradients too, at the same entries (ROADMAP C)
    want = _flat(jgrad["params"])
    nans = 0
    for name, p in tt.model.named_parameters():
        w, g = want[name], p.grad.numpy()
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        nans += int(np.isnan(w).sum())
        if nans and np.isnan(w).all():
            continue
        own = np.nanmax(np.abs(w - witness[name]))
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-4 * np.nanmax(np.abs(w)) + 4 * own,
            err_msg=name)
    assert (nans > 0) == (case == "variogram")
    # one update
    with jax.enable_x64(False):
        jp, _, jmem2, jl2 = jt._get_step(W)(params, opt_state,
                                            jnp.asarray(m0), window, mask)
    _, tl2 = tt.update(twin, torch.tensor(m0), None)
    np.testing.assert_allclose(tl2.item(), float(jl2), rtol=1e-5)
    want = _flat(jp["params"])
    for name, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_ensemble_epochs_and_memory():
    """run_epoch and run_epoch_fused take and return the [M, B, ...]
    memory (fresh zeros for another batch), init gives it, and the default
    noise source keys each draw by (seed, step, member): the same in
    every window."""
    kw = _model_kw({})
    tm = RNNAutoreg(device="cpu", **kw)
    cfg = RolloutConfig(ensemble_size=M, rollout_schedule={0: 2}, seed=1)
    tt = RolloutTrainer(tm, cfg, HYAI, HYBI, device="cpu")
    data = {k: torch.tensor(v) for k, v in _data(T=4).items()}
    mem = tt.init(data)
    assert mem.shape == (M, B, L, NH_MEM) and not mem.any()
    from climsim_tpu_torch.train.rollout import run_epoch_fused
    mem, rec = run_epoch_fused(tt, mem, [data], 0)
    assert rec["updates"] == 2 and np.isfinite(rec["loss"])
    assert mem.shape == (M, B, L, NH_MEM)
    mem, rec = tt.run_epoch(torch.zeros(M, B + 1, L, NH_MEM), [data], 0,
                            train=False)
    assert mem.shape == (M, B, L, NH_MEM) and rec["updates"] == 2
    noise = KeyedNoise(1, "cpu")
    a, b = noise(0, 1, (L, B, 12)), noise(0, 1, (L, B, 12))
    assert torch.equal(a, b)
    assert not torch.equal(a, noise(1, 1, (L, B, 12)))
    assert not torch.equal(a, noise(0, 2, (L, B, 12)))


def test_ensemble_refuses_apply_fn():
    tm = RNNAutoreg(device="cpu", **_model_kw({}))
    with pytest.raises(ValueError, match="apply_fn"):
        RolloutTrainer(tm, RolloutConfig(ensemble_size=2), HYAI, HYBI,
                       device="cpu", apply_fn=lambda *a: None)
