"""The physics-constrained emulator's other options (ROADMAP A.11) in the
port against the JAX package, on the CPU: ML radiation heads
(``use_physrad=False``) and the separate radiation BiGRU, TripleClouds
(``use_tc``), learned cloud optics, both together, and the BF16 policy
with the scan and the fused trunk; forward outputs, memory and aux
fields, and a loss's gradient with respect to every parameter, on one
parameter tree carried across by ``from_flax_params``.

The trees are the port's own seeded init (flax's layout, lecun-normal
kernels, the radiation's constants) with every leaf perturbed by 5% so no
bias sits at zero; ``test_flax_trees_match`` holds each new tree's names
and shapes to JAX's (from the case's gradient tree, or ``jax.eval_shape``
of ``init``). JAX's forward and gradient come from one jitted
``value_and_grad`` a case, compiled at XLA's backend optimization level
0 (``torch_jit.jit_o0``). JAX runs with 64-bit
types off, as tests/test_torch_phys_model.py explains.

Tolerances: float32 to ``RTOL`` (1e-4) of each output's scale, as
test_torch_phys_model.py holds the physical radiation; gradients to
``G_RTOL`` (3e-4) of each gradient's scale, as test_torch_phys_train.py.

``learned_cloud_optics`` runs in float64 in both packages (the policy,
the parameters and the inputs; the port's plain solvers stand in for the
wrappers, which take float32 and run those same plain versions on CPU
tensors): its learned SW optics put a layer of these data at
|1 - (k mu0)^2| = 5e-4, next to the Meador-Weaver singularity of
physics/radiation.py::calc_ref_trans_sw, where float32 rounding moves 38
of the 73 gradients by more than G_RTOL under a 1e-6 relative
perturbation of the parameters (up to 2.5e-2 of a gradient's scale). In
float64 the port is within 1.5e-7 of JAX's outputs and 2.4e-6 of its
gradients, so it is held to RTOL and G_RTOL with no allowance.

BF16: both packages round the same arrays to bfloat16 (the pressures,
yscales, output buffer, cloud paths, gases; JAX's weakly typed scalars
first), but the jitted JAX program keeps some bfloat16 chains in float32
where torch rounds each operation. Readings at these shapes (the largest
error of any output or aux field as a share of its scale; of any
gradient as a share of its scale): the port under BF16 1.9e-3 and
8.6e-3; the port under F32 5.6e-2 and 0.25; the port under BF16 without
``weak``'s rounding of the scalars 4.2e-2 (5.5e-3 in the outputs alone)
and 4.5e-2. ``BF16_TOL`` (3e-3) and ``BF16_G_TOL`` (2e-2) lie between the
sound reading and the others, and
``test_bf16_tolerances_catch_a_wrong_policy`` asserts that both wrong
policies fail them."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models.common import BF16 as JBF16
from climsim_tpu.models.common import Policy as JaxPolicy
from climsim_tpu.models.phys_rnn import PhysicalRNNAutoreg as JaxPhys
from climsim_tpu_torch.models import (BF16, F32, PhysicalRNNAutoreg,
                                      from_flax_params)
from climsim_tpu_torch.models import phys_rad, phys_rnn
from climsim_tpu_torch.models.common import Policy, weak
from climsim_tpu_torch.ops import adding_sw_fast, fused_bigru_lbh
from climsim_tpu_torch.physics import radiation as R
from test_torch_phys_model import HY, NX, NX_SFC, NY, NY_SFC, _inputs
from torch_jit import jit_o0

RTOL, G_RTOL, BF16_TOL, BF16_G_TOL = 1e-4, 3e-4, 3e-3, 2e-2
BASE = dict(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=(16, 16),
            nh_mem=8, nreg=6, store_precip=True, ice_sedimentation=True,
            use_physrad=True, ng_lw=8, ng_sw=8, sp_mean=9.8e4, sp_div=1.0, yscale_t=1e5,
            yscale_qv=1e8, yscale_qn=1e8, yscale_precc=1e12, **HY)
NOPHYS = dict(use_physrad=False)
# (options, gradients held too: each option's gradients once, the
# others' forward only, to hold the file's time)
CASES = {
    "ml_radiation": (NOPHYS, True),
    "separate_radiation": (dict(NOPHYS, separate_radiation=True), True),
    "tripleclouds": (dict(use_tc=True), True),
    "learned_cloud_optics": (dict(learned_cloud_optics=True,
                                  policy="f64"), True),
    "tripleclouds_learned": (dict(use_tc=True, learned_cloud_optics=True),
                             False),
    "tripleclouds_mcica": (dict(use_tc=True, use_mcica=True,
                                use_qv_variability=True), False),
    "bf16": (dict(policy="bf16"), True),
    "bf16_fused": (dict(policy="bf16", use_pallas=True), False),
}
B = 6
JAX_F64 = JaxPolicy(jnp.float64, jnp.float64, jnp.float64)
F64 = Policy(torch.float64, torch.float64, torch.float64)


def _kw(case, framework):
    kw = {**BASE, **CASES[case][0]}
    policy = kw.pop("policy", None)
    if policy is not None:
        kw["policy"] = {("bf16", "jax"): JBF16, ("bf16", "torch"): BF16,
                        ("f64", "jax"): JAX_F64,
                        ("f64", "torch"): F64}[policy, framework]
    return kw


def _f64(case) -> bool:
    return CASES[case][0].get("policy") == "f64"


@contextlib.contextmanager
def _port_solvers(case):
    """In a float64 case the physics model calls the plain solvers."""
    if not _f64(case):
        yield
        return
    saved = phys_rad.lw_solver_noscat_fast, phys_rad.adding_sw_fast
    phys_rad.lw_solver_noscat_fast = R.lw_solver_noscat
    phys_rad.adding_sw_fast = R.adding_sw
    try:
        yield
    finally:
        phys_rad.lw_solver_noscat_fast, phys_rad.adding_sw_fast = saved


@functools.lru_cache(maxsize=None)
def _case(case):
    """(port model, inputs, JAX's outputs, JAX's gradients by parameter
    name, the loss's weights)."""
    f64 = _f64(case)
    dt = np.float64 if f64 else np.float32
    a = tuple(np.asarray(x, dt)
              for x in _inputs(B, seed=11, nh_mem=BASE["nh_mem"]))
    tm = PhysicalRNNAutoreg(**_kw(case, "torch"), device="cpu", seed=3)
    rng = np.random.default_rng(5)
    tree = {}
    for name, v in tm.state_dict().items():
        v = v.numpy()
        leaf = (v + 0.05 * np.abs(v).max() * rng.standard_normal(v.shape)
                if v.size and np.abs(v).max() > 0
                else 0.05 * rng.standard_normal(v.shape))
        node = tree
        for k in name.split(".")[:-1]:
            node = node.setdefault(k, {})
        node[name.split(".")[-1]] = np.asarray(np.asarray(leaf, np.float32),
                                               dt)
    if f64:
        tm.double()
    tm.load_state_dict(from_flax_params(tree, tm))
    with torch.no_grad(), _port_solvers(case):
        w = _weights(tm(*map(torch.as_tensor, a)))
    jm = JaxPhys(**_kw(case, "jax"))
    flat = {}
    with jax.enable_x64(f64):
        params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
        ja = list(map(jnp.asarray, a))
        if CASES[case][1]:
            def loss(p):
                out = jm.apply(p, *ja)
                return _loss(jnp, out, w), out

            (_, want), grads = jit_o0(
                jax.value_and_grad(loss, has_aux=True), params)
            flat = {".".join(str(k.key) for k in path): np.asarray(g)
                    for path, g in jax.tree_util.tree_flatten_with_path(
                        grads["params"])[0]}
        else:
            want = jit_o0(jm.apply, params, *ja)
    return tm, a, jax.tree_util.tree_map(np.asarray, want), flat, w


def _port_run(case, grads: bool):
    """The port's outputs (and the loss's gradients by name)."""
    tm, a, _, _, w = _case(case)
    tm.zero_grad(set_to_none=True)
    with torch.set_grad_enabled(grads), _port_solvers(case):
        out = tm(*map(torch.as_tensor, a))
        if grads:
            _loss(torch, out, w).backward()
    g = {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
         for n, p in tm.named_parameters()}
    return ([o.detach().numpy() for o in out[:3]],
            {k: v.detach() for k, v in out[3].items()}, g)


def _weights(out):
    """Constant weights: one over each output channel's squared scale."""
    return [1.0 / np.maximum(np.abs(np.asarray(o, np.float32)).reshape(
        -1, o.shape[-1]).max(0), 1e-30) ** 2 for o in out[:3]]


def _loss(xp, out, w):
    """A scalar of every output channel: the weighted mean squares of the
    level and surface outputs and of the memory (its stored pool too)."""
    return sum(xp.mean(o * o * xp.asarray(wi)) for o, wi in zip(out[:3], w))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _forward_error(case) -> float:
    """The port's largest forward error against JAX: of each output and
    aux field, as a share of that field's scale."""
    _, _, want, _, _ = _case(case)
    got, aux, _ = _port_run(case, False)
    errs = [_rel(g, w) for g, w in zip(got, want[:3])]
    return max(errs + [_rel(aux[k], w) for k, w in want[3].items()])


def _gradient_error(case) -> float:
    """The port's largest gradient error against JAX, as a share of each
    gradient's scale."""
    jg = _case(case)[3]
    tg = _port_run(case, True)[2]
    return max(float(np.abs(tg[n] - g).max() / np.abs(g).max())
               for n, g in jg.items() if np.abs(g).max() > 0)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    """Outputs, memory and every aux field against the flax model."""
    want = _case(case)[2]
    tol = BF16_TOL if "bf16" in case else RTOL
    dtype = np.float64 if _f64(case) else np.float32
    got, aux, _ = _port_run(case, False)
    for g, w in zip(got, want[:3]):
        assert g.shape == w.shape and g.dtype == w.dtype == dtype
        assert np.isfinite(g).all()
        assert _rel(g, w) <= tol, _rel(g, w)
    assert set(aux) == set(want[3])
    for k, w in want[3].items():
        assert _rel(aux[k], w) <= tol, (k, _rel(aux[k], w))


@pytest.mark.parametrize("case", [c for c, (_, g) in CASES.items() if g])
def test_gradients_match_jax(case):
    """The loss's gradient with respect to every parameter, each to its
    tolerance of that gradient's largest magnitude."""
    jg = _case(case)[3]
    tol = BF16_G_TOL if "bf16" in case else G_RTOL
    tg = _port_run(case, True)[2]
    assert set(tg) == set(jg)
    reached = 0
    for name, want in jg.items():
        scale = np.abs(want).max()
        reached += bool(scale > 0)
        assert (np.abs(tg[name] - want) <= tol * scale).all(), name
    assert reached >= len(jg) - 2


@pytest.mark.parametrize("held", ["forward", "gradients"])
def test_bf16_tolerances_catch_a_wrong_policy(held, monkeypatch):
    """The BF16 tolerances fail the port run under F32, and the port run
    under BF16 without ``weak``'s bfloat16 rounding of the Python
    scalars, against JAX's BF16 results, while the port under BF16 holds
    (the readings are in the module's docstring)."""
    case, tol, error = {
        "forward": ("bf16", BF16_TOL, _forward_error),
        "gradients": ("bf16", BF16_G_TOL, _gradient_error)}[held]
    tm = _case(case)[0]
    assert error(case) <= tol
    monkeypatch.setattr(tm, "policy", F32)
    assert error(case) > tol
    monkeypatch.setattr(tm, "policy", BF16)
    for mod in (phys_rnn, phys_rad):
        monkeypatch.setattr(mod, "weak", lambda v, dtype: v)
    assert error(case) > tol


TREES = {"ml_radiation": ("mlp_output_rad.kernel",
                          "mlp_surface_output_rad.bias"),
         "separate_radiation": ("rnn1_rad.input_proj.kernel",
                                "rnn2_rad.cell.hh.bias",
                                "mlp_surface_init_rad.kernel",
                                "mlp_toa_rad.bias", "mlp_output_rad.kernel"),
         "tripleclouds": ("mlp_overlap.kernel",),
         "tripleclouds_learned": ("radiation.cld_lw.kernel",
                                  "mlp_overlap.bias"),
         "learned_cloud_optics": ("radiation.cld_lw.kernel",
                                  "radiation.cld_sw1.kernel",
                                  "radiation.cld_sw2.bias")}


@pytest.mark.parametrize("case", list(TREES))
def test_flax_trees_match(case):
    """Every leaf of JAX's parameter tree of each new option maps onto one
    port parameter with its shape (``from_flax_params`` takes it), and
    the option's own leaves are there. The tree is JAX's gradient's where
    the case holds gradients, else ``init``'s traced by
    ``jax.eval_shape``, which compiles nothing."""
    if CASES[case][1]:
        flat = {k: g.shape for k, g in _case(case)[3].items()}
    else:
        a = list(map(jnp.asarray,
                     _inputs(B, seed=11, nh_mem=BASE["nh_mem"])))
        with jax.enable_x64(False):
            shapes = jax.eval_shape(JaxPhys(**_kw(case, "jax")).init,
                                    jax.random.PRNGKey(0), *a)
        flat = {".".join(str(k.key) for k in path): tuple(v.shape)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    shapes["params"])[0]}
    tm = PhysicalRNNAutoreg(**_kw(case, "torch"), device="cpu")
    assert flat == {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert set(TREES[case]) <= set(flat)


def test_kernels_on_the_new_paths_stay_plain_on_the_cpu():
    """On CPU tensors the new paths run the plain versions: the fused
    trunk at all 60 levels (ML radiation, alone and with the separate
    radiation BiGRU) launches no B7 and gives finite outputs of the scan
    trunk's shapes, and TripleClouds takes the SW through the plain
    adding_sw_tc, never B11's wrapper."""
    b7, b11 = fused_bigru_lbh.launches, adding_sw_fast.launches
    for case in ("ml_radiation", "separate_radiation"):
        tm, a, want = _case(case)[:3]
        fused = PhysicalRNNAutoreg(**_kw(case, "torch"), use_pallas=True,
                                   device="cpu", seed=3)
        with torch.no_grad():
            out = fused(*map(torch.as_tensor, a))
        for o, w in zip(out[:3], want[:3]):
            assert tuple(o.shape) == w.shape and torch.isfinite(o).all()
    _port_run("tripleclouds", False)
    assert fused_bigru_lbh.launches == b7
    assert adding_sw_fast.launches == b11


def test_bf16_scalars_round_as_jax():
    """Under BF16 a Python scalar meets a bfloat16 array rounded to
    bfloat16 first, as JAX's weakly typed scalars do (the pressures'
    1e5 becomes 99840), and the model's pressures follow."""
    with jax.enable_x64(False):
        j = jnp.asarray(HY["hyam"], jnp.bfloat16) * 1e5
        assert float(jnp.asarray(1e5, jnp.bfloat16)) == 99840.0
    t = torch.tensor(HY["hyam"]).to(torch.bfloat16)
    assert weak(1e5, torch.bfloat16) == 99840.0
    assert weak(1e5, torch.float32) == 1e5
    np.testing.assert_array_equal(
        (t * weak(1e5, torch.bfloat16)).float().numpy(),
        np.asarray(j, np.float32))
    assert not torch.equal(t * 1e5, t * weak(1e5, torch.bfloat16))
