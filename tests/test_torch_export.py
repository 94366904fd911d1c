"""The port's deployment export (``export/serialize.py``, the
``climsim::`` custom ops of ``ops/library.py``, ``export/validate.py``
and the rollout CLI's ``export_path``) on the CPU: the ``torch.export``
round trip; the v2, v3 and v4 wrappers and the v6 and physics models
exported with their kernel as one ``torch.ops.climsim.*`` node and
reloaded equal to the eager step, once in a fresh process that builds no
model; the CLI's artifacts for the GRU and physics yamls; and the
validation harness against the JAX package's.

Exported and eager steps run the same operations on the same inputs, so
they are held to be equal (``torch.equal``); the harness's report is held
to JAX's at rtol 1e-6."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.export.validate import \
    ensemble_error_correlation as jax_corr
from climsim_tpu.export.validate import validate_export as jax_validate
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu_torch.cli import train_rollout as cli
from climsim_tpu_torch.data import LevelNormalizer
from climsim_tpu_torch.export import (OnlineWrapper, WrapperConfig,
                                      export_step, export_wrapper, load_step)
from climsim_tpu_torch.export import serialize
from climsim_tpu_torch.export.validate import (ensemble_error_correlation,
                                               offline_rollout,
                                               validate_export)
from climsim_tpu_torch.models import PhysicalRNNAutoreg, RNNAutoreg
from climsim_tpu_torch.ops import library

from test_torch_train_cli import write_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, NX, NX_SFC, NH_MEM = 6, 60, 15, 24, 4
ARMS = {"v2": (dict(use_pallas=True), "fused_bigru_lbh"),
        "v3": (dict(use_pallas=True, fuse_heads=True),
               "fused_bigru_heads_lbh"),
        "v4": (dict(use_pallas=True, fuse_heads=True, fuse_init=True),
               "fused_bigru_heads_init_lbh")}
# an exported wrapper whose recurrences are the kernel's one node has
# ~190 nodes; the scan arm, whose 2 x 60 levels unroll, has ~3,500
MAX_NODES = 400


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def raw_inputs(seed=0, batch=B):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(0.5, 0.2, (batch, L, NX)))
    x[..., 0] = rng.uniform(220, 300, (batch, L))
    x[..., 2:4] = np.abs(rng.normal(0, 1e-5, (batch, L, 2)))
    xs = np.abs(rng.normal(0.5, 0.2, (batch, NX_SFC)))
    mem = rng.normal(0, 0.5, (batch, L, NH_MEM))
    return [a.astype(np.float32) for a in (x, xs, mem)]


def make_wrapper(arm):
    model = RNNAutoreg(nx=NX, nx_sfc=NX_SFC, ny=5, ny_sfc=8, nneur=(16, 16),
                       nh_mem=NH_MEM, add_pres=False, device="cpu",
                       **ARMS[arm][0])
    norm = LevelNormalizer(torch.zeros(1, NX), torch.ones(1, NX),
                           torch.zeros(NX_SFC), torch.ones(NX_SFC),
                           torch.full((1, 5), 1e3), torch.ones(8))
    lbd = np.full(L, 1e4, np.float32)
    return OnlineWrapper(model, norm, lbd, lbd, lbd, WrapperConfig(mp_mode=1))


def call(step, arrays):
    with torch.no_grad():
        return step(*[torch.as_tensor(a) for a in arrays])


def assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_export_step_roundtrip(tmp_path):
    """As tests/test_infra.py::test_export_serialize_roundtrip for JAX."""
    def step(x, y):
        return torch.tanh(x) @ y

    x, y = torch.ones(4, 8), torch.ones(8, 3)
    path = str(tmp_path / "step.pt2")
    n = export_step(step, (x, y), path)
    assert n > 0 and os.path.getsize(path) == n
    got = load_step(path)(x, y)
    np.testing.assert_allclose(got.numpy(), step(x, y).numpy(), rtol=1e-6)


@pytest.mark.parametrize("arm", list(ARMS))
def test_export_wrapper_holds_one_kernel_node(arm, tmp_path):
    w = make_wrapper(arm)
    assert w.model.arm == arm
    path = str(tmp_path / f"{arm}.pt2")
    n = export_wrapper(w, B, L, NX, NX_SFC, NH_MEM, path)
    assert n == os.path.getsize(path)
    program = torch.export.load(path)
    assert library.exported_ops(program.graph) == \
        [f"climsim.{ARMS[arm][1]}.default"]
    assert len(list(program.graph.nodes)) < MAX_NODES
    arrays = raw_inputs(1)
    arrays[0][0, 3, 7] = np.nan                       # scrubbed inside
    assert_equal(call(load_step(path), arrays), call(w, arrays))


FRESH = r"""
import sys
import numpy as np
import torch
import climsim_tpu_torch.models as M

def refuse(*a, **k):
    raise AssertionError("the loading process built a model or loaded "
                         "parameters")

for cls in (M.RNNAutoreg, M.PhysicalRNNAutoreg):
    cls.__init__ = refuse
torch.nn.Module.load_state_dict = refuse
from climsim_tpu_torch.export import load_step
root = sys.argv[1]
step = load_step(root + "/step.pt2")
args = [torch.from_numpy(np.load(f"{root}/in{i}.npy")) for i in range(3)]
with torch.no_grad():
    outs = step(*args)
for i, o in enumerate(outs):
    np.save(f"{root}/out{i}.npy", o.numpy())
"""


def test_reload_in_fresh_process(tmp_path):
    """A process given only the artifact and the inputs loads the step
    through load_step, builds no model and reads no parameters, and its
    outputs equal the eager wrapper's."""
    w = make_wrapper("v4")
    export_wrapper(w, B, L, NX, NX_SFC, NH_MEM, str(tmp_path / "step.pt2"))
    arrays = raw_inputs(2)
    for i, a in enumerate(arrays):
        np.save(tmp_path / f"in{i}.npy", a)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", FRESH, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = call(w, arrays)
    for i, t in enumerate(want):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{i}.npy"),
                                      t.numpy())


@pytest.mark.parametrize("fuse_init,op", [
    (True, "fused_bigru_heads_init_cm"), (False, "fused_bigru_heads_cm")])
def test_export_level_major_model(fuse_init, op, tmp_path):
    """export_step on a v6 (B1) or v5 (B4) model's forward, which JAX's
    export_step also takes: the channel-major [L, C, B] step."""
    model = RNNAutoreg(nx=6, nx_sfc=NX_SFC, ny=6, ny_sfc=8, nneur=(16, 16),
                       nh_mem=NH_MEM, add_pres=False, use_pallas=True,
                       fuse_heads=True, fuse_init=fuse_init,
                       level_major=True, device="cpu")
    rng = np.random.default_rng(3)
    arrays = [rng.normal(0, 1, s).astype(np.float32)
              for s in ((L, 6, B), (B, NX_SFC), (L, NH_MEM, B))]
    path = str(tmp_path / "lm.pt2")
    export_step(model.forward, [torch.tensor(a) for a in arrays], path)
    program = torch.export.load(path)
    assert library.exported_ops(program.graph) == [f"climsim.{op}.default"]
    assert_equal(call(load_step(path), arrays), call(model, arrays))


def test_export_physics_model(tmp_path):
    """The physics model's forward with the fused trunk: B7 and the
    radiation solvers B11 and B12 as climsim:: nodes, reloaded equal."""
    g = JaxGrid.synthetic(4, L)
    tt = lambda a: tuple(float(x) for x in np.asarray(a))
    model = PhysicalRNNAutoreg(
        nx=NX, nx_sfc=NX_SFC, ny=5, ny_sfc=8, nneur=(16, 16), nh_mem=8,
        nreg=8, store_precip=True, ice_sedimentation=True, use_physrad=True,
        use_mcica=True, use_qv_variability=True, ng_lw=8, ng_sw=8,
        use_pallas=True, sp_mean=9.8e4, sp_div=1.0, hyai=tt(g.hyai),
        hybi=tt(g.hybi), hyam=tt(g.hyam), hybm=tt(g.hybm), yscale_t=1e5,
        yscale_qv=1e8, yscale_qn=1e8, yscale_precc=1e7, device="cpu")
    rng = np.random.default_rng(4)
    xd = np.zeros((B, L, 6), np.float32)
    xd[..., 0] = rng.uniform(200, 300, (B, L))
    xd[..., 2:4] = np.abs(rng.normal(0, 1e-5, (B, L, 2)))
    xd[..., -1] = np.abs(rng.normal(1e-3, 3e-4, (B, L)))
    arrays = [rng.normal(0, 1, (B, L, NX)).astype(np.float32),
              rng.normal(0, 1, (B, NX_SFC)).astype(np.float32),
              np.abs(rng.normal(0, 0.1, (B, L - 10, 9))).astype(np.float32),
              xd]
    step = cli._PhysStep(model)
    path = str(tmp_path / "phys.pt2")
    export_step(step, [torch.tensor(a) for a in arrays], path)
    ops = set(library.exported_ops(torch.export.load(path).graph))
    assert ops == {"climsim.fused_bigru_lbh.default",
                   "climsim.adding_sw_fast.default",
                   "climsim.lw_solver_noscat_fast.default"}
    assert_equal(call(load_step(path), arrays), call(step, arrays))


def test_export_refuses_a_ctypes_wrapper(tmp_path):
    """A step that reaches a kernel that is not a registered op raises
    naming the wrapper, not a fake-tensor traceback."""
    from climsim_tpu_torch.ops import fv_advect_levels

    def step(q, u, v):
        return fv_advect_levels(q, u, v, 0.1, 0.1)

    q = torch.rand(2, 4, 8)
    with pytest.raises(RuntimeError, match="fv_advect_levels"):
        export_step(step, (q, q, q), str(tmp_path / "fv.pt2"))


CLI_CASES = {
    "gru_scan": ("autoreg_gru.yaml", [], set()),
    "gru_v2": ("autoreg_gru.yaml", ["model.use_pallas=true"],
               {"climsim.fused_bigru_lbh.default"}),
    "physrnn": ("autoreg_physrnn.yaml", [],
                {"climsim.adding_sw_fast.default",
                 "climsim.lw_solver_noscat_fast.default"}),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_export_path(case, tmp_path, monkeypatch, capsys):
    """train_rollout ... export_path=...: one epoch at tiny widths on the
    CPU; the artifact reloads and equals the trained model's eager
    forward at the first training step's inputs."""
    yaml, over, ops = CLI_CASES[case]
    grid = str(tmp_path / "grid.nc")
    write_grid(grid)
    seen = {}
    orig = serialize.export_step

    def spy(fn, example_args, path):
        seen.update(fn=fn, args=example_args)
        return orig(fn, example_args, path)

    monkeypatch.setattr(serialize, "export_step", spy)
    path = str(tmp_path / "model.pt2")
    assert cli.main([os.path.join(REPO, "conf", yaml), "device=cpu",
                     f"grid_path={grid}", "epochs=1", "model.nneur=[16,16]",
                     "data.ncol=32", "data.steps=6",
                     f"export_path={path}"] + over) == 0
    n = os.path.getsize(path)
    assert f"exported {n} bytes of torch.export program to {path}" in \
        capsys.readouterr().out
    assert set(library.exported_ops(torch.export.load(path).graph)) == ops
    assert_equal(call(load_step(path), seen["args"]),
                 call(seen["fn"], seen["args"]))


def test_validate_export_matches_jax():
    """JAX's tests/test_aux.py::test_export_validation_harness case, with
    a wrapper that is not exact, against JAX's report at rtol 1e-6."""
    T, Bv, ny, ns = 4, 8, 6, 8
    rng = np.random.default_rng(1)
    xm = rng.normal(0, 1, (T, Bv, L, ny)).astype(np.float32)
    xs = rng.normal(0, 1, (T, Bv, ns)).astype(np.float32)
    yt = (0.1 * xm + 0.01 * rng.normal(0, 1, xm.shape)).astype(np.float32)
    yts = rng.normal(0, 0.1, (T, Bv, ns)).astype(np.float32)

    def tw(x, s, m):
        return 0.1 * x[..., :ny], torch.zeros(x.shape[0], ns), m + 1.0

    def jw(x, s, m):
        return 0.1 * x[..., :ny], jnp.zeros((x.shape[0], ns)), m + 1.0

    got = validate_export(tw, torch.tensor(xm), torch.tensor(xs),
                          torch.tensor(yt), torch.tensor(yts),
                          torch.zeros(Bv, L, 4))
    want = jax_validate(jw, jnp.asarray(xm), jnp.asarray(xs),
                        jnp.asarray(yt), jnp.asarray(yts),
                        jnp.zeros((Bv, L, 4), jnp.float32))
    assert set(got) == set(want) and got["passed"] and want["passed"]
    for k in ("nan_frac", "lev_bias", "lev_rmse", "sfc_bias", "sfc_rmse",
              "rel_rmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    # exact wrapper: zero error, and a NaN fails the gate
    zero = validate_export(tw, torch.tensor(xm), torch.tensor(xs),
                           torch.tensor(0.1 * xm), torch.zeros(T, Bv, ns),
                           torch.zeros(Bv, L, 4))
    np.testing.assert_allclose(zero["lev_rmse"], 0.0, atol=1e-7)
    xm[0, 0, 0, 0] = np.nan
    assert not validate_export(tw, torch.tensor(xm), torch.tensor(xs),
                               torch.tensor(yt), torch.tensor(yts),
                               torch.zeros(Bv, L, 4))["passed"]


def test_offline_rollout_refuses_free_running():
    """offline_rollout is teacher-forced: JAX's accepts teacher_forced=False
    and ignores it; the port's raises rather than run the teacher-forced
    rollout under that name."""
    def step(x, s, m):
        return x, s, m
    xm, xs, m0 = torch.zeros(2, 3, L, 4), torch.zeros(2, 3, 5), \
        torch.zeros(3, L, 2)
    out, out_sfc, mem = offline_rollout(step, xm, xs, m0)
    assert out.shape == xm.shape and out_sfc.shape == xs.shape
    with pytest.raises(NotImplementedError, match="HybridLoop"):
        offline_rollout(step, xm, xs, m0, teacher_forced=False)


def test_ensemble_error_correlation_matches_jax():
    """JAX's tests/test_aux.py::test_ensemble_error_correlation case."""
    rng = np.random.default_rng(0)
    truth = rng.normal(0, 1, (256, 60))
    indep = truth[None] + rng.normal(0, 1, (8, 256, 60))
    shared = truth[None] + rng.normal(0, 1, (256, 60))[None] \
        + 0.05 * rng.normal(0, 1, (8, 256, 60))
    for ens, lo, hi in ((indep, -0.05, 0.05), (shared, 0.9, 1.0)):
        got = float(ensemble_error_correlation(torch.tensor(ens),
                                               torch.tensor(truth)))
        want = float(jax_corr(jnp.asarray(ens), jnp.asarray(truth)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert lo < got < hi
