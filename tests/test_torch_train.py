"""The port's rollout training (losses, LR schedules, conservation terms,
``RolloutTrainer``) against the JAX package's, on the CPU, with the same
flagship-shaped small model (the channel-major fused v6 path), the same
numpy-seeded data and the same flax parameters."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import common as jcommon
from climsim_tpu.models.rnn import RNNAutoreg as JaxRNNAutoreg
from climsim_tpu.physics import conservation as jcons
from climsim_tpu.train import losses as jlosses
from climsim_tpu.train import schedules as jsched
from climsim_tpu.train.rollout import (RolloutConfig as JaxConfig,
                                       RolloutTrainer as JaxTrainer)
from climsim_tpu_torch.models import (RNNAutoreg, from_flax_params,
                                      from_optax_adam)
from climsim_tpu_torch.models import common as tcommon
from climsim_tpu_torch.ops import (bigru_heads_cm_bwd,
                                   fused_bigru_heads_init_cm)
from climsim_tpu_torch.physics import conservation as tcons
from climsim_tpu_torch.train import (RolloutConfig, RolloutTrainer,
                                     channel_major_apply)
from climsim_tpu_torch.train import losses as tlosses
from climsim_tpu_torch.train import schedules as tsched

NX, NX_SFC, NY, NY_SFC = 6, 24, 6, 8
NNEUR, NH_MEM, L, B = (16, 16), 4, 16, 12
FLAGS = dict(level_major=True, fuse_heads=True, fuse_init=True,
             use_pallas=True, add_pres=False, output_prune=True)
# tendencies in physical units are the outputs divided by these
YSCALE_LEV = np.array([1e5, 1e8, 1e9, 1e9, 1e5, 1e5], np.float32)
YSCALE_SCA = np.array([1e-2, 1e-2, 1e8, 1e8, 1e-2, 1e-2, 1e-2, 1e-2],
                      np.float32)
HYAI = np.linspace(2e-3, 0.0, L + 1).astype(np.float32)
HYBI = np.linspace(0.0, 1.0, L + 1).astype(np.float32)
# the window's parameter gradients: the same arithmetic up to summation
# order in float32 over 2 x 16 recurrent levels and a few losses
G_RTOL, G_ATOL = 2e-4, 1e-6


def _data(T, seed=3):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(0, 0.3, s).astype(np.float32)
    return {"x_lev": r(T, B, L, NX), "x_sfc": r(T, B, NX_SFC),
            "y_lev": r(T, B, L, NY), "y_sfc": r(T, B, NY_SFC),
            "sp": (1e5 + 1e3 * rng.standard_normal((T, B))).astype(
                np.float32)}


def _jax_apply(jm):
    """The channel-major model behind the trainer's [B, L, C] contract:
    the same adapter as the port's ``channel_major_apply``."""
    tr = lambda a: jnp.transpose(a, (1, 2, 0))

    def apply(p, xl, xs, m, xr):
        out, out_sfc, mem = jm.apply(p, tr(xl), xs, tr(m))
        return (jnp.transpose(out, (2, 0, 1)), out_sfc,
                jnp.transpose(mem, (2, 0, 1)))
    return apply


def _models(policy="F32"):
    jm = JaxRNNAutoreg(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC,
                       nneur=NNEUR, nh_mem=NH_MEM,
                       policy=getattr(jcommon, policy), **FLAGS)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((L, NX, B), jnp.float32),
                     jnp.zeros((B, NX_SFC), jnp.float32),
                     jnp.zeros((L, NH_MEM, B), jnp.float32))
    tm = RNNAutoreg(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=NNEUR,
                    nh_mem=NH_MEM, policy=getattr(tcommon, policy),
                    device="cpu", **FLAGS)
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    return jm, params, tm


def _trainers(policy="F32", **cfg):
    jm, params, tm = _models(policy)
    kw = dict(yscale_lev=YSCALE_LEV, yscale_sca=YSCALE_SCA)
    jt = JaxTrainer(jm, JaxConfig(**cfg), HYAI, HYBI, apply_fn=_jax_apply(jm),
                    **kw)
    tt = RolloutTrainer(tm, RolloutConfig(**cfg), HYAI, HYBI,
                        apply_fn=channel_major_apply, device="cpu", **kw)
    return jt, params, tt


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ------------------------------------------------------------ losses


def _pair(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape).astype(np.float32),
            rng.normal(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("name", ["huber", "mse", "mae"])
def test_losses_match_jax(name):
    p, t = _pair(1, 8, 5, 3)
    w = np.random.default_rng(2).uniform(0.5, 2, (5, 3)).astype(np.float32)
    got = tlosses.LOSS_FNS[name](torch.as_tensor(p), torch.as_tensor(t))
    want = jlosses.LOSS_FNS[name](jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got = tlosses.weighted_loss(torch.as_tensor(p), torch.as_tensor(t),
                                torch.as_tensor(w), kind=name)
    want = jlosses.weighted_loss(jnp.asarray(p), jnp.asarray(t),
                                 jnp.asarray(w), kind=name)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("scale", [1e-6, 1e-3])
def test_gel_precip_loss_matches_jax(scale):
    """Both sides of the E = 30 switch from exponential to linear."""
    rng = np.random.default_rng(4)
    ts = np.abs(rng.normal(0, scale, (3 * 10, NY_SFC))).astype(np.float32)
    ps = np.abs(rng.normal(0, scale, (3 * 10, NY_SFC))).astype(np.float32)
    got = tlosses.gel_precip_loss(torch.as_tensor(ts), torch.as_tensor(ps),
                                  3, lam=0.7)
    want = jlosses.gel_precip_loss(jnp.asarray(ts), jnp.asarray(ps), 3,
                                   lam=0.7)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_absolute_bias_loss_matches_jax():
    pl, tl = _pair(5, 20, L, NY)
    ps, ts = _pair(6, 20, NY_SFC)
    tl[3, 14, 2] = np.nan                       # nanmean skips it
    got = tlosses.absolute_bias_loss(*map(torch.as_tensor, (pl, tl, ps, ts)))
    want = jlosses.absolute_bias_loss(*map(jnp.asarray, (pl, tl, ps, ts)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ------------------------------------------------------------ schedules

SCHEDULES = {
    "cyclical": (lambda m: m.cyclical(1e-4, 1e-3, 50), 200),
    "step_decay": (lambda m: m.step_decay(1e-3, 30, 0.5), 100),
    "one_cycle_cos": (lambda m: m.one_cycle(1e-3, 100), 100),
    "one_cycle_linear": (lambda m: m.one_cycle(1e-3, 100, pct_start=0.25,
                                               annealing="linear"), 100),
    "warmup_constant": (lambda m: m.warmup_constant(1e-3, 40), 80),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    """Each schedule at steps 0, 1, mid and end (and just past the
    boundaries where it changes shape) against the JAX package's optax
    schedule, which evaluates in float32."""
    make, end = SCHEDULES[name]
    t, j = make(tsched), make(jsched)
    for step in sorted({0, 1, 29, 30, 31, end // 2, end - 1, end, end + 5}):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"{name} step {step}")


# ------------------------------------------------------------ conservation


def test_conservation_matches_jax():
    rng = np.random.default_rng(7)
    yl = (rng.normal(0, 1, (2 * B, L, NY)) / YSCALE_LEV).astype(np.float32)
    ys = (rng.normal(0, 1, (2 * B, NY_SFC)) / YSCALE_SCA).astype(np.float32)
    yl2 = (yl * 1.3).astype(np.float32)
    ys2 = (ys * 0.7).astype(np.float32)
    sp = (1e5 + 1e3 * rng.standard_normal(2 * B)).astype(np.float32)
    t = lambda *a: [torch.as_tensor(x) for x in a]
    j = lambda *a: [jnp.asarray(x) for x in a]
    pairs = [
        (tcons.layer_thickness(*t(sp, HYAI, HYBI), 0.1),
         jcons.layer_thickness(*j(sp, HYAI, HYBI), 0.1)),
        (tcons.energy_residual(*t(yl, ys, sp, HYAI, HYBI)),
         jcons.energy_residual(*j(yl, ys, sp, HYAI, HYBI))),
        (tcons.energy_conservation_mse(*t(yl, ys, yl2, ys2, sp, HYAI, HYBI),
                                       timesteps=2),
         jcons.energy_conservation_mse(*j(yl, ys, yl2, ys2, sp, HYAI, HYBI),
                                       timesteps=2)),
        (tcons.water_residual(*t(yl, ys, sp, HYAI, HYBI)),
         jcons.water_residual(*j(yl, ys, sp, HYAI, HYBI))),
        (tcons.water_conservation_mse(*t(yl, ys, sp, HYAI, HYBI),
                                      timesteps=2),
         jcons.water_conservation_mse(*j(yl, ys, sp, HYAI, HYBI),
                                      timesteps=2)),
        (tcons.cloud_water_path(*t(yl, sp, HYAI, HYBI)),
         jcons.cloud_water_path(*j(yl, sp, HYAI, HYBI))),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=str(i))


# ------------------------------------------------------------ the trainer

WINDOW_CASES = {
    "plain": dict(loss="mse"),
    "remat": dict(loss="mse", remat=True),
    "replay_full_terms": dict(
        loss="huber", replay="full", replay_slice=(0, 3), pred_slice=(0, 3),
        w_energy=1e-3, w_water=1e-3, w_cld=1e-3, w_precip=1e-2,
        w_bias=0.5, w_gel_precip=1e-6, strat_temp_weight_factor=2.0,
        scalar_weight_factor=0.5),
    "replay_mixed_remat": dict(
        loss="mae", replay="mixed", replay_slice=(2, 5), pred_slice=(1, 4),
        gradual_mixing_end_epoch=1, remat=True, w_energy=1e-3),
}


def _window_both(cfg, W=2, policy="F32"):
    jt, params, tt = _trainers(policy, **cfg)
    data = _data(W)
    mask = np.ones((B,), np.float32)
    mem = np.random.default_rng(9).normal(0, 0.5, (B, L, NH_MEM)).astype(
        np.float32)

    def jloss(p):
        return jt._window_loss(p, {k: jnp.asarray(v) for k, v in
                                   data.items()}, jnp.asarray(mem),
                               jnp.asarray(mask))
    (jl, jmem), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tl, tmem = tt._window_loss({k: torch.as_tensor(v) for k, v in
                                data.items()}, torch.as_tensor(mem),
                               torch.as_tensor(mask))
    tl.backward()
    tg = {n: p.grad.numpy() for n, p in tt.model.named_parameters()}
    return (float(jl), np.asarray(jmem), _flat(jg["params"])), \
        (tl.item(), tmem.detach().numpy(), tg)


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_loss_and_grads_match_jax(case):
    """One window's loss, new memory and every parameter gradient against
    jax.value_and_grad of the JAX trainer's ``_window_loss``."""
    (jl, jmem, jg), (tl, tmem, tg) = _window_both(WINDOW_CASES[case])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tmem, jmem, rtol=2e-5, atol=2e-6)
    assert set(tg) == set(jg)
    for name, g in tg.items():
        assert np.abs(g).max() > 0, f"no gradient reaches {name}"
        np.testing.assert_allclose(g, jg[name], rtol=G_RTOL,
                                   atol=G_ATOL * np.abs(jg[name]).max(),
                                   err_msg=f"{case}: d{name}")


def test_window_grads_bf16_policy():
    """BF16 policy: the layer's .to(bf16) views carry the bf16 weight
    gradients back to the float32 parameters, as flax's casts do. The two
    packages round at different points (JAX differentiates its batch-major
    composition), so each gradient may differ from JAX's bf16 gradient by
    4x JAX's own bf16-vs-f32 difference, plus 1e-3 of its scale."""
    (jl, _, jg), (tl, _, tg) = _window_both(dict(loss="mse"),
                                            policy="BF16")
    (_, _, jg32), _ = _window_both(dict(loss="mse"))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)   # measured 1.4e-4
    for name, g in tg.items():
        assert g.dtype == np.float32 and np.abs(g).max() > 0, name
        own = np.abs(jg[name] - jg32[name]).max()
        err = np.abs(g - jg[name]).max()
        assert err <= 4 * own + 1e-3 * np.abs(jg32[name]).max(), \
            f"d{name}: {err:.3e} > 4 x {own:.3e}"


def test_remat_changes_nothing():
    """Checkpointing each window step recomputes the same arithmetic, so
    the loss and gradients are bit-identical to the plain loop (on the
    card B1 then launches twice per step, forward and recompute: the cuda
    tests count it)."""
    fused_bigru_heads_init_cm.launches = bigru_heads_cm_bwd.launches = 0
    _, (l0, m0, g0) = _window_both(dict(loss="mse"))
    _, (l1, m1, g1) = _window_both(dict(loss="mse", remat=True))
    assert l0 == l1
    np.testing.assert_array_equal(m0, m1)
    for name in g0:
        np.testing.assert_array_equal(g0[name], g1[name], err_msg=name)
    # on the CPU the wrappers run the plain versions and launch nothing
    assert fused_bigru_heads_init_cm.launches == 0
    assert bigru_heads_cm_bwd.launches == 0


@pytest.mark.parametrize("replay", [None, "mixed"])
def test_two_updates_match_jax(replay):
    """Two updates of ``run_epoch`` (one chunk of 4 steps, W 2) from a
    carried non-zero Adam state against the JAX trainer. The loss record
    agrees tightly. Adam divides each moment by the root of the second
    moment, so where a gradient is near zero its update flips with the
    gradient's last bits: the parameters are held to 2% of one update's
    size (lr) on top of a relative 1e-5."""
    lr = 1e-3
    cfg = dict(loss="mse", lr=lr, rollout_schedule={0: 2}, replay=replay,
               replay_slice=(0, 3), pred_slice=(0, 3),
               gradual_mixing_end_epoch=1, remat=True, w_water=1e-3)
    jt, params, tt = _trainers(**cfg)
    rng = np.random.default_rng(11)
    flat = _flat(params["params"])
    mu = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
          for k, v in flat.items()}
    nu = {k: rng.uniform(1e-7, 1e-6, v.shape).astype(np.float32)
          for k, v in flat.items()}
    def tree(values):
        out = {}
        for key, v in values.items():
            mod, leaf = key.split(".")
            out.setdefault(mod, {})[leaf] = v
        return {"params": out}
    adam = jt.tx.init(params)
    adam = (adam[0]._replace(count=jnp.asarray(3, jnp.int32),
                             mu=jax.tree_util.tree_map(jnp.asarray, tree(mu)),
                             nu=jax.tree_util.tree_map(jnp.asarray,
                                                       tree(nu))),) \
        + tuple(adam[1:])
    tt.opt.load_state_dict(from_optax_adam(tree(mu), tree(nu), 3, tt.model,
                                           tt.opt))
    chunk = _data(4, seed=5)
    jp, _, jmem, jrec = jt.run_epoch(params, adam, None, [chunk], epoch=0)
    tmem, trec = tt.run_epoch(None, [chunk], epoch=0)
    for k in ("epoch", "window", "mix_frac", "updates"):
        assert trec[k] == jrec[k], k
    assert trec["updates"] == 2 and trec["mix_frac"] == (
        1.0 if replay else 0.0)
    np.testing.assert_allclose(trec["loss"], jrec["loss"], rtol=1e-5)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), rtol=1e-4,
                               atol=1e-5)
    jflat = _flat(jp["params"])
    for name, p in tt.model.named_parameters():
        assert np.abs(p.detach().numpy() - flat[name]).max() > 0.1 * lr, \
            f"{name} did not move"
        np.testing.assert_allclose(p.detach().numpy(), jflat[name],
                                   rtol=1e-5, atol=0.02 * lr, err_msg=name)


def test_timestepped_optimizer_rescales_lr():
    cfg = RolloutConfig(loss="mse", lr=1e-3, timestepped_optimizer=True,
                        rollout_schedule={0: 1, 1: 2})
    _, _, tm = _models()
    tt = RolloutTrainer(tm, cfg, HYAI, HYBI, apply_fn=channel_major_apply,
                        device="cpu")
    _, rec0 = tt.run_epoch(None, [_data(2)], epoch=0)
    opt0 = tt.opt
    _, rec1 = tt.run_epoch(None, [_data(2)], epoch=1)
    assert (rec0["window"], rec1["window"]) == (1, 2)
    assert (rec0["updates"], rec1["updates"]) == (2, 1)
    assert tt.opt is not opt0 and math.isclose(cfg.lr, 2e-3)
    assert tt.opt.param_groups[0]["lr"] == pytest.approx(2e-3)


def test_lr_schedule_drives_the_optimizer():
    """The optimizer's lr before update n is the schedule at n."""
    cfg = RolloutConfig(loss="mse", lr=1e-3, lr_schedule="warmup",
                        warmup_steps=4, rollout_schedule={0: 1})
    _, _, tm = _models()
    tt = RolloutTrainer(tm, cfg, HYAI, HYBI, apply_fn=channel_major_apply,
                        device="cpu")
    sched = jsched.warmup_constant(1e-3, 4)
    seen = []
    for _ in range(3):
        tt.run_epoch(None, [_data(1)], epoch=0)
        seen.append(tt.opt.param_groups[0]["lr"])
    np.testing.assert_allclose(seen, [float(sched(n)) for n in range(3)],
                               rtol=1e-6)


def test_eval_epoch_leaves_parameters():
    _, _, tt = _trainers(loss="mse", rollout_schedule={0: 2})
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    mem, rec = tt.run_epoch(None, [_data(4)], epoch=0, train=False)
    assert rec["updates"] == 2 and np.isfinite(rec["loss"])
    assert mem.shape == (B, L, NH_MEM)
    for n, p in tt.model.named_parameters():
        torch.testing.assert_close(p, before[n], rtol=0, atol=0)


def test_init_gives_zero_memory_and_fresh_optimizer():
    _, _, tt = _trainers(loss="mse", rollout_schedule={0: 1})
    tt.run_epoch(None, [_data(1)], epoch=0)
    assert tt.opt.state
    window = {k: torch.as_tensor(v) for k, v in _data(1).items()}
    mem = tt.init(window)
    assert mem.shape == (B, L, NH_MEM) and not mem.any()
    assert not tt.opt.state


# options that raised before the ensemble training, the optimizers and
# semi-online training were ported; each now runs
PORTED = [dict(w_det=1.0), dict(ensemble_size=2), dict(optimizer="soap"),
          dict(optimizer="muon"), dict(optimizer="schedulefree"),
          dict(semi_online=True)]
_ids = lambda d: "-".join(f"{k}={v}" for k, v in d.items())


@pytest.mark.parametrize("over", PORTED, ids=_ids)
def test_ported_options_run(over):
    """Two updates of the channel-major model against JAX's trainer: the
    epoch's loss within 1e-5, the parameters within 1e-5 relative plus 2%
    of one update's size (muon, schedule-free; w_det, which JAX reads
    only in ensemble training). SOAP's first update moves nothing, in
    both; its second preconditions with the first gradient's
    eigenbases, which a degenerate eigenvalue of these rectangular
    weights leaves free, so only the loss is held here (SOAP against JAX:
    test_torch_optimizers.py, and through the CLI with JAX's bases
    replayed: test_torch_train_cli_stoch.py). The ensemble runs a
    batch-major stochastic model (its trainer calls the model directly,
    as JAX's does) and carries the [M, B, ...] memory (against JAX:
    test_torch_ensemble_rollout.py)."""
    lr = 1e-3
    if "ensemble_size" in over:
        tm = RNNAutoreg(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC,
                        nneur=NNEUR, nh_mem=NH_MEM, add_pres=False,
                        add_stochastic_layer=True, device="cpu")
        tt = RolloutTrainer(tm, RolloutConfig(
            loss="mse", lr=lr, rollout_schedule={0: 2}, **over), HYAI, HYBI,
            device="cpu")
        mem, rec = tt.run_epoch(None, [_data(4)], epoch=0)
        assert mem.shape == (2, B, L, NH_MEM) and rec["updates"] == 2
        assert np.isfinite(rec["loss"])
        return
    jt, params, tt = _trainers(loss="mse", lr=lr, rollout_schedule={0: 1},
                               **over)
    flat = _flat(params["params"])
    chunk = _data(2, seed=5)
    if over.get("semi_online"):
        # the raw state and raw true tendencies of the rebuilt channels
        rng = np.random.default_rng(6)
        chunk["x_lev_raw"] = np.abs(rng.normal(1.0, 0.1, (2, B, L, NX))
                                    ).astype(np.float32)
        chunk["y_lev_raw"] = rng.normal(0, 1e-5, (2, B, L, NY)).astype(
            np.float32)
    jp, _, _, jrec = jt.run_epoch(params, jt.tx.init(params), None,
                                  [chunk], epoch=0)
    _, trec = tt.run_epoch(None, [chunk], epoch=0)
    assert trec["updates"] == jrec["updates"] == 2
    np.testing.assert_allclose(trec["loss"], jrec["loss"], rtol=1e-5)
    jflat = _flat(jp["params"])
    for name, p in tt.model.named_parameters():
        got = p.detach().numpy()
        assert np.all(np.isfinite(got)) and \
            np.abs(got - flat[name]).max() > 0.01 * lr, name
        if over.get("optimizer") != "soap":
            np.testing.assert_allclose(got, jflat[name], rtol=1e-5,
                                       atol=0.02 * lr, err_msg=name)


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tm = _models()
    with pytest.raises(RuntimeError, match="CUDA"):
        RolloutTrainer(tm, RolloutConfig(), HYAI, HYBI)
