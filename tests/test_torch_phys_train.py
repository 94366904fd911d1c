"""Rollout training of the port's physics-constrained emulator against the
JAX package's, on the CPU: a teacher-forced window's loss and gradients
and a two-update epoch of a small ``PhysicalRNNAutoreg`` in
``conf/autoreg_physrnn.yaml``'s configuration with the yaml's loss and
optimizer (as cli/train_rollout.py wires ``type: physrnn``), with the
fused trunk and with the scan trunk that the yaml itself builds (equal
and unequal widths), the raw-state loss terms (``w_rh``, ``w_qvpos``,
``w_qnpos``, ``w_precip_neg``) and ``rh_consistency_loss``.

The JAX side runs with 64-bit types off (``jax.enable_x64(False)``), as
tests/test_torch_phys_model.py explains.

The model's precipitation scale is 1e12, where chip_smoke.py's is 1e7: the
stored-precipitation cap Pmax grows with it, and with random weights and
the smaller scale every column's pool hits the cap, where the release
fraction no longer changes the outputs. Its gradient is then exactly
zero, and what either package computes is the float32 residue of
g wn - g wn, which no tolerance relative to its own size can hold. Here
the pools stay under the cap and that gradient is a real one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.models.phys_rnn import PhysicalRNNAutoreg as JaxPhys
from climsim_tpu.train import losses as jlosses
from climsim_tpu.train.rollout import (RolloutConfig as JaxConfig,
                                       RolloutTrainer as JaxTrainer)
from climsim_tpu_torch.models import (PhysicalRNNAutoreg, from_flax_params,
                                      from_optax_adam)
from climsim_tpu_torch.ops import (adding_sw_bwd, adding_sw_fast,
                                   bigru_bwd_lbh, fused_bigru_lbh,
                                   lw_solver_noscat_bwd,
                                   lw_solver_noscat_fast)
from climsim_tpu_torch.train import (RolloutConfig, RolloutTrainer,
                                     phys_apply, phys_mem_shape)
from climsim_tpu_torch.train import losses as tlosses

L, NX, NX_SFC, NY, NY_SFC, B, W = 60, 15, 24, 5, 8, 8, 2
_g = JaxGrid.synthetic(4, L)
_tt = lambda a: tuple(float(x) for x in np.asarray(a))
HY = dict(hyai=_tt(_g.hyai), hybi=_tt(_g.hybi), hyam=_tt(_g.hyam),
          hybm=_tt(_g.hybm))
# conf/autoreg_physrnn.yaml's options with the fused trunk
# (use_pallas=True), at narrow widths
MODEL = dict(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=(16, 16),
             nh_mem=4, nreg=4, store_precip=True, ice_sedimentation=True,
             use_physrad=True, use_mcica=True, use_tc=False,
             use_qv_variability=True, learned_cloud_optics=False, ng_lw=8,
             ng_sw=8, use_pallas=True, pallas_acc32=True, sp_mean=9.8e4,
             sp_div=1.0, yscale_t=1e5, yscale_qv=1e8, yscale_qn=1e8,
             yscale_precc=1e12, **HY)
# the yaml's own model: the scan trunk (the yaml sets no use_pallas, and
# cli/train_rollout.py:294 defaults it to False), equal and unequal widths
SCAN_TRUNKS = {"scan": dict(MODEL, use_pallas=False),
               "scan-unequal": dict(MODEL, use_pallas=False, nneur=(16, 12))}
# per-channel output scales as cli/train_rollout.py:401-402 passes them
YSCALE_LEV = np.array([1e5, 1e8, 1e8, 1e5, 1e5], np.float32)[None, None]
YSCALE_SCA = np.array([1e-2, 1e-2, 1e12, 1e12, 1e-2, 1e-2, 1e-2, 1e-2],
                      np.float32)
# the yaml's loss and optimizer: huber, w_main 1, w_hcon 5e-6 and w_wcon
# 3e7 (cli/train_rollout.py:352-353), Adam 5e-4; pass_x_raw, and
# pass_y_true = use_physrad and update_states_for_rad (:394-395)
YAML_CFG = dict(rollout_schedule={0: W}, loss="huber", w_main=1.0,
                w_energy=5e-6, w_water=3e7, optimizer="adam", lr=5e-4,
                pass_x_raw=True, pass_y_true=True)
# gradients: the same float32 arithmetic in another order of summation
# through 2 x 50 recurrent levels, 120 radiation levels per step and the
# gas-optics MLPs (measured up to 1.4e-4 of a gradient's scale, in the SW
# gas optics)
G_RTOL = 3e-4


def _raw_state(rng, n):
    """The raw level state [n, L, 6]: T, qv, qc, qi and qv again in the
    model's qv channel (-1), in physical ranges."""
    xd = np.zeros((n, L, 6), np.float32)
    xd[..., 0] = rng.uniform(200, 300, (n, L))
    xd[..., 1] = np.abs(rng.normal(1e-3, 3e-4, (n, L)))
    xd[..., 2] = np.abs(rng.normal(0, 1e-5, (n, L)))
    xd[..., 3] = np.abs(rng.normal(0, 1e-5, (n, L)))
    xd[..., 5] = xd[..., 1]
    return xd


def _chunk(T, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return {"x_lev": n(T, B, L, NX), "x_sfc": n(T, B, NX_SFC),
            "y_lev": 0.3 * n(T, B, L, NY), "y_sfc": 0.3 * n(T, B, NY_SFC),
            "sp": rng.uniform(9.6e4, 1.03e5, (T, B)).astype(np.float32),
            "x_lev_raw": np.stack([_raw_state(rng, B) for _ in range(T)])}


def _jax_trainer(jm, cfg, model=MODEL):
    return JaxTrainer(jm, JaxConfig(**cfg), np.asarray(HY["hyai"]),
                      np.asarray(HY["hybi"]), yscale_lev=YSCALE_LEV,
                      yscale_sca=YSCALE_SCA,
                      apply_fn=lambda p, xl, xs, m, xr, yt=None: jm.apply(
                          p, xl, xs, m, xr, yt),
                      mem_shape=lambda b, n: (b, L - 10, model["nh_mem"] + 1))


def _port(params, cfg=YAML_CFG, model=MODEL):
    """The port's model with the flax parameters, and its trainer."""
    tm = PhysicalRNNAutoreg(**model, device="cpu")
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    tr = RolloutTrainer(tm, RolloutConfig(**cfg), HY["hyai"], HY["hybi"],
                        yscale_lev=YSCALE_LEV, yscale_sca=YSCALE_SCA,
                        apply_fn=phys_apply, mem_shape=phys_mem_shape(tm),
                        device="cpu")
    return tm, tr


def _jax_init(model):
    chunk = _chunk(1, seed=1)
    mem = np.zeros((B, L - 10, model["nh_mem"] + 1), np.float32)
    with jax.enable_x64(False):
        jm = JaxPhys(**model)
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(chunk["x_lev"][0]),
                         jnp.asarray(chunk["x_sfc"][0]), jnp.asarray(mem),
                         jnp.asarray(chunk["x_lev_raw"][0]))
    return jm, params


@pytest.fixture(scope="module")
def jax_model():
    return _jax_init(MODEL)


@pytest.fixture(scope="module", params=list(SCAN_TRUNKS))
def jax_scan_model(request):
    model = SCAN_TRUNKS[request.param]
    return _jax_init(model) + (model,)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _held(got, want, rtol, name):
    """|got - want| <= rtol * |want|max."""
    err = np.abs(got - want).max()
    tol = rtol * np.abs(want).max()
    assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def test_window_loss_and_grads_match_jax(jax_model):
    """One teacher-forced W 2 window (y_true reaches the radiation, the
    memory carries a stored-precipitation pool): the loss, the new memory
    and every parameter's gradient against jax.value_and_grad of the JAX
    trainer's ``_window_loss``."""
    _window_parity(*jax_model, MODEL)


def test_scan_trunk_window_loss_and_grads_match_jax(jax_scan_model):
    """test_window_loss_and_grads_match_jax with the yaml's scan trunk."""
    _window_parity(*jax_scan_model)


def _window_parity(jm, params, model):
    chunk = _chunk(W, seed=2)
    rng = np.random.default_rng(3)
    mem = np.abs(rng.normal(0, 0.1, (B, L - 10, model["nh_mem"] + 1))
                 ).astype(np.float32)
    mask = np.zeros((B,), np.float32)
    with jax.enable_x64(False):
        jt = _jax_trainer(jm, YAML_CFG, model)
        (jl, jmem), jg = jax.value_and_grad(
            lambda p: jt._window_loss(
                p, {k: jnp.asarray(v) for k, v in chunk.items()},
                jnp.asarray(mem), jnp.asarray(mask)), has_aux=True)(params)
    jg = _flat(jg["params"])

    tm, tr = _port(params, model=model)
    tl, tmem = tr._window_loss({k: torch.as_tensor(v)
                                for k, v in chunk.items()},
                               torch.as_tensor(mem), torch.as_tensor(mask))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _held(tmem.detach().numpy(), np.asarray(jmem), 1e-5, "memory")
    tg = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(tg) == set(jg)
    reached = 0
    for name, g in tg.items():
        reached += bool(np.abs(g).max() > 0)
        _held(g, jg[name], G_RTOL, name)
    # the surface-output head feeds only channels the physics overwrites,
    # so its gradient is zero in both packages; every other one is not
    assert reached == len(tg) - 2


def test_two_updates_match_jax(jax_model):
    """Two updates of ``run_epoch`` (one chunk of 4 steps, W 2) from a
    carried non-zero Adam state against the JAX trainer: the loss record
    and the memory, then every parameter to 1e-5 of its size plus 2% of
    one Adam step (lr): where a gradient is near zero Adam's step flips
    with its last bits (tests/test_torch_train.py holds the flagship to the
    same)."""
    _two_updates_parity(*jax_model, MODEL)


def test_scan_trunk_two_updates_match_jax(jax_scan_model):
    """test_two_updates_match_jax with the yaml's scan trunk, from an Adam
    state whose moments have the scale of each parameter's gradient, as
    training reaches (the bias-corrected second moment of the fourth step,
    250 nu, ~4-16 times the gradient's square): it then bounds how far
    the last bits of a gradient move a step (with the fixed 1e-7..1e-6 of
    the test above,
    a float32 rounding residue of a zero gradient, 1e-8 of its parameter's
    gradient scale, moves mlp_output.bias by 8% of lr). The stored
    precipitation after the second window is a column sum that cancels:
    scaling JAX's own parameters by 1 + 1e-7 N(0, 1) moves it by 2e-4 of
    its scale (unequal widths; measured), so it is held to 1e-3 of its
    scale, the latent memory to 1e-5 as above."""
    _two_updates_parity(*jax_scan_model, matched=True, pool_rtol=1e-3)


def _gradient_scales(jt, params, chunk, model):
    """max |gradient| of each parameter on the chunk's first window from
    zero memory (JAX's), floored at 1e-3 for the parameters without one."""
    mem = jnp.zeros((B, L - 10, model["nh_mem"] + 1), jnp.float32)
    window = {k: jnp.asarray(v[:W]) for k, v in chunk.items()}
    g = jax.grad(lambda p: jt._window_loss(
        p, window, mem, jnp.zeros((B,), jnp.float32))[0])(params)
    return jax.tree_util.tree_map(
        lambda a: max(float(jnp.abs(a).max()), 1e-3), g)


def _two_updates_parity(jm, params, model, matched=False, pool_rtol=1e-5):
    lr = YAML_CFG["lr"]
    rng = np.random.default_rng(12)
    chunk = _chunk(4, seed=5)
    with jax.enable_x64(False):
        jt = _jax_trainer(jm, YAML_CFG, model)
        if matched:
            scale = _gradient_scales(jt, params, chunk, model)
        else:
            scale = jax.tree_util.tree_map(lambda p: None, params)
        mu = jax.tree_util.tree_map(
            lambda p, s: rng.normal(0, s or 1e-3, p.shape).astype(np.float32),
            params, scale)
        nu = jax.tree_util.tree_map(
            lambda p, s: (rng.uniform(0.25, 1.0, p.shape) * (s / 4) ** 2
                          if s
                          else rng.uniform(1e-7, 1e-6, p.shape)).astype(
                np.float32), params, scale)
        adam = jt.tx.init(params)
        adam = (adam[0]._replace(
            count=jnp.asarray(3, jnp.int32),
            mu=jax.tree_util.tree_map(jnp.asarray, mu),
            nu=jax.tree_util.tree_map(jnp.asarray, nu)),) + tuple(adam[1:])
        # the JAX update donates its parameters: give it a copy
        jp, _, jmem, jrec = jt.run_epoch(
            jax.tree_util.tree_map(jnp.copy, params), adam, None, [chunk], 0)
    jp = _flat(jp["params"])

    tm, tr = _port(params, model=model)
    tr.opt.load_state_dict(from_optax_adam(mu, nu, 3, tm, tr.opt))
    tmem, trec = tr.run_epoch(None, [chunk], 0)
    assert trec["updates"] == jrec["updates"] == 2
    np.testing.assert_allclose(trec["loss"], jrec["loss"], rtol=1e-5)
    tmem, jmem = tmem.numpy(), np.asarray(jmem)
    _held(tmem[..., :-1], jmem[..., :-1], 1e-5, "latent memory")
    _held(tmem[..., -1], jmem[..., -1], pool_rtol, "stored precipitation")
    flat = _flat(params["params"])
    for name, p in tm.named_parameters():
        p = p.detach().numpy()
        assert np.abs(p - flat[name]).max() > 0.1 * lr, f"{name} is stuck"
        np.testing.assert_allclose(p, jp[name], rtol=1e-5, atol=0.02 * lr,
                                   err_msg=name)


def test_update_on_cpu_launches_nothing(jax_model):
    """On the CPU the wrappers run the plain versions: one update of the
    physics model launches none of B7, B8, B11, B12, B13 or B14."""
    _, params = jax_model
    wrappers = (fused_bigru_lbh, bigru_bwd_lbh, adding_sw_fast,
                lw_solver_noscat_fast, adding_sw_bwd, lw_solver_noscat_bwd)
    before = [w.launches for w in wrappers]
    _, tr = _port(params)
    _, rec = tr.run_epoch(None, [_chunk(W, seed=6)], 0)
    assert rec["updates"] == 1 and np.isfinite(rec["loss"])
    assert [w.launches for w in wrappers] == before


# ------------------------------------------------------- raw-state terms


class _Stub(nn.Module):
    """A stand-in model whose raw tendencies, surface outputs and
    negative-precipitation aux are linear in two parameter vectors, so
    that a loss term's value and gradients can be held against JAX."""

    def __init__(self, a, b):
        super().__init__()
        self.a = nn.Parameter(torch.as_tensor(a))
        self.b = nn.Parameter(torch.as_tensor(b))


def _stub_apply(m, xl, xs, mem, xr):
    out_sfc = xs[..., :NY_SFC] * m.b
    return (xl[..., :NY] * 1e-6 * m.a, out_sfc, mem,
            {"prec_negative": torch.relu(-out_sfc[:, 3])})


def _jax_stub_apply(p, xl, xs, mem, xr):
    out_sfc = xs[..., :NY_SFC] * p["b"]
    return (xl[..., :NY] * 1e-6 * p["a"], out_sfc, mem,
            {"prec_negative": jax.nn.relu(-out_sfc[:, 3])})


# weights that make each term of the order of the main loss on these data
TERMS = {"w_rh": dict(w_rh=1e-2, rh_max=1.05),
         "w_qvpos": dict(w_qvpos=1e6),
         "w_qnpos-mp_mode-1": dict(w_qnpos=1e6, mp_mode=1),
         "w_qnpos-mp_mode-0": dict(w_qnpos=1e6, mp_mode=0),
         "w_precip_neg": dict(w_precip_neg=1e-1)}


@pytest.mark.parametrize("term", sorted(TERMS))
def test_raw_state_term_matches_jax(term):
    """Each raw-state term (tests/test_rollout_loss_terms.py) with the raw
    state passed through: the window's loss, the term's share of it, and
    the gradients of both parameter vectors against the JAX trainer, to
    1e-5 (float32 means over the window in another order). The data make
    every term bite: cold upper levels supersaturate, and some qv, qn and
    precipitation go negative after a step."""
    rng = np.random.default_rng(7)
    chunk = _chunk(W, seed=8)
    a = rng.uniform(0.5, 1.5, NY).astype(np.float32)
    b = rng.uniform(0.5, 1.5, NY_SFC).astype(np.float32)
    mem = np.zeros((B, L, 4), np.float32)
    mask = np.zeros((B,), np.float32)
    results = {}
    for name, extra in (("base", {}), ("term", TERMS[term])):
        cfg = dict(loss="mse", rollout_schedule={0: W}, pass_x_raw=True,
                   **extra)
        with jax.enable_x64(False):
            jt = JaxTrainer(object(), JaxConfig(**cfg),
                            np.asarray(HY["hyai"]), np.asarray(HY["hybi"]),
                            apply_fn=_jax_stub_apply)
            jl, jg = jax.value_and_grad(lambda p: jt._window_loss(
                p, {k: jnp.asarray(v) for k, v in chunk.items()},
                jnp.asarray(mem), jnp.asarray(mask))[0])(
                {"a": jnp.asarray(a), "b": jnp.asarray(b)})
        stub = _Stub(a, b)
        tr = RolloutTrainer(stub, RolloutConfig(**cfg), HY["hyai"],
                            HY["hybi"], apply_fn=_stub_apply, device="cpu")
        tl, _ = tr._window_loss({k: torch.as_tensor(v)
                                 for k, v in chunk.items()},
                                torch.as_tensor(mem), torch.as_tensor(mask))
        tl.backward()
        results[name] = (tl.item(), float(jl))
        for k, g in (("a", stub.a.grad), ("b", stub.b.grad)):
            want = np.asarray(jg[k])
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{term} {name} d{k}")
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    share = results["term"][0] - results["base"][0]
    assert share > 1e-3 * results["base"][0], f"{term} does not bite"
    np.testing.assert_allclose(share, results["term"][1]
                               - results["base"][1], rtol=1e-4)


@pytest.mark.parametrize("rh_max", [1.05, 0.5])
def test_rh_consistency_loss_matches_jax(rh_max):
    """``rh_consistency_loss`` alone, with its gradients in the two
    tendencies, against the JAX package's on [B, L] fields, to 1e-5."""
    rng = np.random.default_rng(9)
    raw = _raw_state(rng, B)
    dqv = rng.normal(0, 1e-6, (B, L)).astype(np.float32)
    dT = rng.normal(0, 1e-3, (B, L)).astype(np.float32)
    sp = rng.uniform(9.6e4, 1.03e5, B).astype(np.float32)
    p_int = 1e5 * np.asarray(HY["hyai"], np.float32)[None] \
        + np.asarray(HY["hybi"], np.float32)[None] * sp[:, None]
    pmid = (0.5 * (p_int[:, 1:] + p_int[:, :-1])).astype(np.float32)
    args = (raw[..., 1], raw[..., 0], pmid)
    with jax.enable_x64(False):
        jl, (jdq, jdt) = jax.value_and_grad(
            lambda q, t: jlosses.rh_consistency_loss(
                q, t, *map(jnp.asarray, args), rh_max=rh_max),
            argnums=(0, 1))(jnp.asarray(dqv), jnp.asarray(dT))
    q, t = (torch.as_tensor(x).requires_grad_(True) for x in (dqv, dT))
    tl = tlosses.rh_consistency_loss(q, t, *map(torch.as_tensor, args),
                                     rh_max=rh_max)
    tl.backward()
    assert float(jl) > 0
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, want in ((q.grad, jdq), (t.grad, jdt)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
