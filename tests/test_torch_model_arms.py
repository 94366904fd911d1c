"""The port's RNNAutoreg in its v5, batch-major v4, v3 and v2, and scan
arms, with and without the pressure feature, against the JAX package's
RNNAutoreg on the same flax parameters, on the CPU; and the fused <->
unfused parameter-tree converters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.models import common as jcommon
from climsim_tpu.models import rnn as jrnn
from climsim_tpu_torch.models import common as tcommon
from climsim_tpu_torch.models import RNNAutoreg, from_flax_params
from climsim_tpu_torch.models import rnn as trnn

NX, NX_SFC, NY, NY_SFC = 6, 24, 6, 8
NNEUR, NH_MEM, L, B = (16, 16), 4, 8, 12
_G = JaxGrid.synthetic(4, nlev=L)
PRES = dict(add_pres=True, hyam=tuple(np.asarray(_G.hyam).tolist()),
            hybm=tuple(np.asarray(_G.hybm).tolist()), sp_mean=9.8e4,
            sp_div=1e3)
V5 = dict(use_pallas=True, fuse_heads=True, fuse_init=False,
          level_major=True)
ARMS = {
    "v5": dict(V5, add_pres=False),
    "v5_unhoisted": dict(V5, add_pres=False, pallas_hoist_proj=False),
    "v5_pres": dict(V5, **PRES),
    "v6_pres": dict(V5, fuse_init=True, **PRES),
    "v2": dict(use_pallas=True, add_pres=False),
    "v2_pres": dict(use_pallas=True, **PRES),
    "scan": dict(add_pres=False),
    "scan_pres": dict(PRES),
    "scan_no_initial_mlp": dict(add_pres=False, use_initial_mlp=False),
    "scan_mem_is_rnn": dict(add_pres=False, nh_mem=16),
    "v3": dict(use_pallas=True, fuse_heads=True, add_pres=False),
    "v3_pres": dict(use_pallas=True, fuse_heads=True, **PRES),
    "v4": dict(use_pallas=True, fuse_heads=True, fuse_init=True,
               add_pres=False),
    "v4_pres": dict(use_pallas=True, fuse_heads=True, fuse_init=True,
                    **PRES),
    "v3_no_initial_mlp": dict(use_pallas=True, fuse_heads=True,
                              fuse_init=True, use_initial_mlp=False,
                              add_pres=False),
}
WANT_ARM = {"v5": "v5", "v5_unhoisted": "v5", "v5_pres": "v5",
            "v6_pres": "v6", "v2": "v2", "v2_pres": "v2", "scan": "scan",
            "scan_pres": "scan", "scan_no_initial_mlp": "scan",
            "scan_mem_is_rnn": "scan", "v3": "v3", "v3_pres": "v3",
            "v4": "v4", "v4_pres": "v4", "v3_no_initial_mlp": "v3"}


def _inputs(flags, seed=11):
    rng = np.random.default_rng(seed)
    nm = flags.get("nh_mem", NH_MEM)
    lm = flags.get("level_major", False)
    xm = rng.normal(0, 1, (L, NX, B) if lm else (B, L, NX))
    xs = rng.normal(0, 1, (B, NX_SFC))
    mem = rng.normal(0, 0.5, (L, nm, B) if lm else (B, L, nm))
    return [a.astype(np.float32) for a in (xm, xs, mem)]


def _models(flags, policy):
    kw = dict(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=NNEUR,
              nh_mem=NH_MEM)
    kw.update(flags)
    jm = jrnn.RNNAutoreg(policy=getattr(jcommon, policy), **kw)
    params = jm.init(jax.random.PRNGKey(0),
                     *[jnp.asarray(a) for a in _inputs(flags)])
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = RNNAutoreg(policy=getattr(tcommon, policy), device="cpu", **kw)
    tm.load_state_dict(from_flax_params(tree, tm))
    return jm, params, tm, tree


def _run(jm, params, tm, arrays):
    jout = jm.apply(params, *[jnp.asarray(a) for a in arrays])
    with torch.no_grad():
        tout = tm(*[torch.as_tensor(a) for a in arrays])
    return [np.asarray(a, np.float32) for a in jout], \
        [t.float().numpy() for t in tout]


@pytest.mark.parametrize("arm", list(ARMS))
def test_arm_matches_jax_f32(arm):
    """F32: the JAX model runs its compositions (the v5 kernel's
    batch-major composition, the v2 kernel's scan reference, nn.scan) and
    the port its kernels' plain versions and a Python level loop: the same
    arithmetic up to summation order, through 2 x 8 recurrent levels."""
    flags = ARMS[arm]
    jm, params, tm, _ = _models(flags, "F32")
    assert tm.arm == WANT_ARM[arm]
    jout, tout = _run(jm, params, tm, _inputs(flags))
    for j, t, name in zip(jout, tout, ("out", "out_sfc", "new_mem")):
        assert j.shape == t.shape, name
        np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-6,
                                   err_msg=f"{arm} {name}")


@pytest.mark.parametrize("arm", ["v5", "v2", "scan", "scan_pres", "v3",
                                 "v4"])
def test_arm_matches_jax_bf16(arm):
    """BF16 policy: the activations are bf16, and in the scan arm the whole
    recurrence is (the carry takes the projection's dtype), but XLA and
    torch round bf16 elementwise chains at different places (XLA fuses
    them in f32). So each output may differ from JAX's bf16 output by 4x
    JAX's own bf16-vs-f32 difference, plus 1e-3 of the output's scale."""
    flags = ARMS[arm]
    arrays = _inputs(flags)
    jm16, p16, tm16, _ = _models(flags, "BF16")
    jout, tout = _run(jm16, p16, tm16, arrays)
    jm32 = jrnn.RNNAutoreg(policy=jcommon.F32, nx=NX, nx_sfc=NX_SFC, ny=NY,
                           ny_sfc=NY_SFC, nneur=NNEUR, nh_mem=NH_MEM,
                           **flags)
    j32 = [np.asarray(a) for a in jm32.apply(
        p16, *[jnp.asarray(a) for a in arrays])]
    for j, t, r, name in zip(jout, tout, j32, ("out", "out_sfc", "new_mem")):
        assert np.all(np.isfinite(t)), name
        own = np.abs(j - r).max()
        err = np.abs(t - j).max()
        assert err <= 4.0 * own + 1e-3 * np.abs(r).max(), \
            f"{arm} {name}: {err:.3e} > 4 x {own:.3e}"


def test_batch_major_output_prune():
    flags = ARMS["v2"]
    jm, params, tm, _ = _models(flags, "F32")
    _, (out, _, _) = _run(jm, params, tm, _inputs(flags))
    assert np.all(out[:, :min(12, L), 1:] == 0.0)
    assert np.any(out[:, :, 0] != 0.0)


def test_param_tree_names_match_flax():
    """The new submodules carry flax's names, so each JAX checkpoint loads
    unchanged."""
    _, _, tm, _ = _models(ARMS["scan"], "F32")
    keys = set(tm.state_dict())
    for k in ("rnn_up.input_proj.kernel", "rnn_up.cell.hh.bias",
              "rnn_down.cell.hh.kernel", "mlp_initial.kernel",
              "mlp_latent.bias", "mlp_output.kernel"):
        assert k in keys, k
    _, _, tm, _ = _models(ARMS["v5"], "F32")
    assert {"mlp_initial.kernel", "bigru_fused.win1",
            "bigru_fused.wout"} <= set(tm.state_dict())
    _, _, tm, _ = _models(ARMS["v2"], "F32")
    assert {"bigru_fused.win1", "mlp_latent.kernel"} <= set(tm.state_dict())


@pytest.mark.parametrize("fuse_init", [False, True])
def test_param_converters_match_jax_and_serve_both_arms(fuse_init):
    """params_unfused_to_fused / params_fused_to_unfused give JAX's trees,
    and a batch-major v2 checkpoint converted to the fused layout serves
    the channel-major fused arm (v5, or v6 with fuse_init) with the same
    outputs (f32, summation order)."""
    flags = ARMS["v2"]
    _, _, t2, tree = _models(flags, "F32")
    for conv, jconv, args in (
            (trnn.params_unfused_to_fused, jrnn.params_unfused_to_fused,
             (fuse_init,)),
            (trnn.params_fused_to_unfused, jrnn.params_fused_to_unfused,
             ())):
        src = tree if conv is trnn.params_unfused_to_fused else \
            jrnn.params_unfused_to_fused(tree, fuse_init)
        got, want = conv(src, *args), jconv(src, *args)
        assert jax.tree_util.tree_structure(got) \
            == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fused = trnn.params_unfused_to_fused(tree, fuse_init)
    tf = RNNAutoreg(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=NNEUR,
                    nh_mem=NH_MEM, policy=tcommon.F32, device="cpu",
                    **dict(V5, add_pres=False, fuse_init=fuse_init))
    tf.load_state_dict(from_flax_params(fused, tf))
    xm, xs, mem = (torch.as_tensor(a) for a in _inputs(flags))
    cm = lambda a: a.permute(1, 2, 0).contiguous()        # [B,L,C]->[L,C,B]
    with torch.no_grad():
        o2, s2, m2 = t2(xm, xs, mem)
        of, sf, mf = tf(cm(xm), xs, cm(mem))
    torch.testing.assert_close(of, cm(o2), rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(sf, s2, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(mf, cm(m2), rtol=2e-5, atol=2e-6)


def test_v5_layer_gradients_match_jax():
    """Gradients of the v5 model's parameters (B4's autograd: its backward
    is B3's plain version on the CPU) against jax.grad of the JAX model,
    whose v5 backward differentiates its composition (rtol 2e-4 as the
    JAX suite's v5 gradient test)."""
    flags = ARMS["v5"]
    jm, params, tm, _ = _models(flags, "F32")
    arrays = _inputs(flags)

    def jloss(p):
        o, s, m = jm.apply(p, *[jnp.asarray(a) for a in arrays])
        return jnp.sum(o ** 2) + jnp.sum(s ** 2) + jnp.sum(m ** 2)

    jg = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params))
    want = from_flax_params(jg, tm)
    o, s, m = tm(*[torch.as_tensor(a) for a in arrays])
    ((o ** 2).sum() + (s ** 2).sum() + (m ** 2).sum()).backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=2e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("arm", ["v3", "v4"])
def test_batch_major_fused_gradients_match_jax(arm):
    """Gradients of the v3 and v4 models' parameters (B9/B10's autograd:
    the composition over fused_bigru_lbh, whose backward is B8's plain
    version on the CPU) against jax.grad of the JAX model, whose batch-major
    fused layer differentiates the same composition (rtol 2e-4 as the JAX
    suite's v3/v4 gradient tests)."""
    flags = ARMS[arm]
    jm, params, tm, _ = _models(flags, "F32")
    arrays = _inputs(flags)

    def jloss(p):
        o, s, m = jm.apply(p, *[jnp.asarray(a) for a in arrays])
        return jnp.sum(o ** 2) + jnp.sum(s ** 2) + jnp.sum(m ** 2)

    jg = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params))
    want = from_flax_params(jg, tm)
    o, s, m = tm(*[torch.as_tensor(a) for a in arrays])
    ((o ** 2).sum() + (s ** 2).sum() + (m ** 2).sum()).backward()
    for name, p in tm.named_parameters():
        assert p.grad.abs().max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=2e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("fuse_init", [False, True])
def test_converted_checkpoint_serves_batch_major_fused_arm(fuse_init):
    """A batch-major v2 checkpoint converted by params_unfused_to_fused
    serves the batch-major fused arm (v3, or v4 with fuse_init) with the
    v2 arm's outputs (f32, summation order), and params_fused_to_unfused
    takes the fused model's own tree back to one the v2 arm loads."""
    _, _, t2, tree = _models(ARMS["v2"], "F32")
    flags = dict(use_pallas=True, fuse_heads=True, fuse_init=fuse_init,
                 add_pres=False)
    tf = RNNAutoreg(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=NNEUR,
                    nh_mem=NH_MEM, policy=tcommon.F32, device="cpu", **flags)
    assert tf.arm == ("v4" if fuse_init else "v3")
    tf.load_state_dict(from_flax_params(
        trnn.params_unfused_to_fused(tree, fuse_init), tf))
    arrays = [torch.as_tensor(a) for a in _inputs(ARMS["v2"])]
    with torch.no_grad():
        want, got = t2(*arrays), tf(*arrays)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)
    back = trnn.params_fused_to_unfused(
        {k: {n: p.detach().numpy() for n, p in getattr(tf, k)
             .named_parameters()} for k in dict(tf.named_children())})
    t2.load_state_dict(from_flax_params(back, t2))
    with torch.no_grad():
        again = t2(*arrays)
    for g, w in zip(again, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_batch_major_fused_param_tree_names_match_flax():
    """v3 keeps the initial MLP outside its fused layer, v4 inside (as
    w_init/b_init), both with the heads in bigru_fused."""
    _, _, t3, _ = _models(ARMS["v3"], "F32")
    keys = set(t3.state_dict())
    assert {"mlp_initial.kernel", "bigru_fused.win1", "bigru_fused.wlat",
            "bigru_fused.wout"} <= keys
    assert t3.bigru_fused.win1.shape == (NNEUR[0] + NH_MEM, 3 * NNEUR[0])
    _, _, t4, _ = _models(ARMS["v4"], "F32")
    keys = set(t4.state_dict())
    assert {"bigru_fused.w_init", "bigru_fused.b_init",
            "bigru_fused.wout"} <= keys and "mlp_initial.kernel" not in keys
