"""What the sharded-step test files share (tests/test_torch_sharded_
{step,transport}.py): tests/test_online.py's inputs and real emulator,
the JAX package's single-device and sharded steps on them, the port's
ranks spawned beside them, and the comparison."""
import jax
import jax.numpy as jnp
import numpy as np

from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.models.rnn import RNNAutoreg as JaxRNNAutoreg
from climsim_tpu.online import advection as jadv
from climsim_tpu.online.host_loop import (HostLoopConfig as JaxConfig,
                                          HybridLoop as JaxLoop,
                                          sharded_hybrid_step as jax_sharded)
from climsim_tpu.parallel import make_mesh as jax_make_mesh

import torch_dist_workers as W

RANKS = (2, 4)
NCOL, NLEV = W.NLAT * W.NLON, 60


def inputs():
    """tests/test_online.py's initial state (default_rng(4)), in float32,
    and its surface inputs and zero memory."""
    rng = np.random.default_rng(4)
    f32 = lambda a: np.asarray(a, np.float32)
    state = {"T": f32(rng.uniform(220, 300, (NCOL, NLEV))),
             "qv": f32(np.abs(rng.normal(1e-3, 3e-4, (NCOL, NLEV)))),
             "qc": f32(np.abs(rng.normal(1e-5, 3e-6, (NCOL, NLEV)))),
             "qi": f32(np.abs(rng.normal(1e-5, 3e-6, (NCOL, NLEV)))),
             "u": f32(rng.normal(0, 10, (NCOL, NLEV))),
             "v": f32(rng.normal(0, 3, (NCOL, NLEV)))}
    x_sfc = np.concatenate([np.full((NCOL, 1), 1e5, np.float32),
                            np.ones((NCOL, 23), np.float32)], axis=1)
    return state, np.zeros((NCOL, NLEV, 4), np.float32), x_sfc


def jax_emulator():
    """The JAX emulator of tests/test_online.py::_real_emulator and its
    flax parameters (as numpy, for the port's ranks)."""
    model = JaxRNNAutoreg(**W.EMULATOR)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.ones((8, NLEV, 6), jnp.float32),
                        jnp.ones((8, 24), jnp.float32),
                        jnp.zeros((8, NLEV, 4), jnp.float32))
    xs = jnp.asarray(W.XSCALE, jnp.float32)
    ys = jnp.asarray(W.YSCALE, jnp.float32)

    def emulator(x_main_raw, x_sfc_raw, mem):
        xn = (x_main_raw / xs).astype(jnp.float32)
        out, out_sfc, mem = model.apply(params, xn, x_sfc_raw, mem)
        return out * ys, out_sfc, mem

    return emulator, jax.tree_util.tree_map(np.asarray, params)


def _jax_runs(emulator, cases, state, mem, x_sfc):
    """Per case: JAX's single-device step in columns, and its sharded step
    on each mesh, mapped back to columns; and the proxy grid's gather."""
    grid = JaxGrid.synthetic(NCOL)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    jm, jx = jnp.asarray(mem), jnp.asarray(x_sfc)
    out = {}
    for case in cases:
        over, overlap = W.SHARDED_CASES[case]
        loop = JaxLoop(emulator, grid, JaxConfig(**over))
        single = jax.jit(loop.coupled_step)(js, jm, jx)
        gi, si = loop.gather_idx, loop.scatter_idx
        tog = lambda a: jadv.to_grid(a, gi, W.NLAT, W.NLON)
        sharded = {}
        for n in RANKS:
            st, mm, dg = jax_sharded(loop, jax_make_mesh(n, axis="col"),
                                     overlap=overlap)(
                {k: tog(v) for k, v in js.items()}, jm[gi], tog(jx))
            sharded[n] = ({k: np.asarray(jadv.to_columns(v, si))
                           for k, v in st.items()},
                          np.asarray(mm)[np.asarray(si)], dg)
        out[case] = (single, sharded, np.asarray(gi))
    return out


def sharded_runs(tmp_path_factory, cases, errors=False):
    """The port's ranks on ``cases`` (spawned first, once per rank count;
    with ``errors`` also the refusals) and JAX's runs beside them in this
    process. Returns (JAX's runs, the ranks' results by rank count, the
    initial state)."""
    state, mem, x_sfc = inputs()
    emulator, params = jax_emulator()
    dirs = {n: tmp_path_factory.mktemp(f"sharded{n}") for n in RANKS}
    ctxs = [W.spawn(W.sharded_ranks, n, dirs[n], params, state, mem, x_sfc,
                    tuple(cases), errors) for n in RANKS]
    jax_out = _jax_runs(emulator, cases, state, mem, x_sfc)
    for ctx in ctxs:
        W.join(ctx)
    port = {n: {case: W.load(dirs[n], case, n)
                for case in list(cases) + (["errors"] if errors else [])}
            for n in RANKS}
    return jax_out, port, state


def _port_columns(ranks, gather):
    """The ranks' bands, stacked to the global grid and mapped back to
    columns; the memory back to column order."""
    scatter = np.empty_like(gather)
    scatter[gather] = np.arange(gather.size)
    state = {k: np.concatenate([r["state"][k].numpy() for r in ranks])
             .reshape(NCOL, NLEV)[scatter] for k in ranks[0]["state"]}
    mem = np.concatenate([r["mem"].numpy() for r in ranks])[scatter]
    return state, mem


def _assert_step_agrees(got, want, label, energy_rtol):
    """tests/test_online.py:416-463's bounds: the fields rtol 1e-5 / atol
    1e-8, the memory rtol 1e-5 / atol 5e-7, energy_resid rtol 1e-5 / atol
    1e-6, energy_int ``energy_rtol``. Two departures, where the port and
    JAX round differently and JAX's sharded step and its single-device step
    do not: u and v take an atol of 1e-5 of the field's largest magnitude,
    because one ulp of a departure point or a flux moves a wind near zero
    by ~2e-6 of that magnitude; mean_T, which JAX's test does not check,
    takes T's rtol 1e-5."""
    (gs, gm, gd), (ws, wm, wd) = got, want
    for k in ws:
        w = np.asarray(ws[k])
        atol = 1e-5 * np.abs(w).max() if k in ("u", "v") else 1e-8
        np.testing.assert_allclose(gs[k], w, rtol=1e-5, atol=atol,
                                   err_msg=f"{label}: {k}")
    np.testing.assert_allclose(gm, np.asarray(wm), rtol=1e-5, atol=5e-7,
                               err_msg=f"{label}: mem")
    np.testing.assert_allclose(float(gd["mean_T"]), float(wd["mean_T"]),
                               rtol=1e-5, err_msg=f"{label}: mean_T")
    assert ("energy_int" in gd) == ("energy_int" in wd)
    if "energy_int" in wd:
        np.testing.assert_allclose(float(gd["energy_int"]),
                                   float(wd["energy_int"]), rtol=energy_rtol,
                                   err_msg=f"{label}: energy_int")
        np.testing.assert_allclose(float(gd["energy_resid"]),
                                   float(wd["energy_resid"]), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{label}: energy_resid")


def assert_case(runs, case, ranks, energy_rtol):
    """The port's step on ``ranks`` gloo ranks against JAX's sharded step on
    as many devices and against JAX's single-device coupled step; every
    rank's diagnostics are the same numbers."""
    jax_out, port, _ = runs
    single, sharded, gather = jax_out[case]
    got_state, got_mem = _port_columns(port[ranks][case], gather)
    diags = [{k: float(v) for k, v in r["diags"].items()}
             for r in port[ranks][case]]
    assert all(d == diags[0] for d in diags), diags
    got = (got_state, got_mem, diags[0])
    _assert_step_agrees(got, sharded[ranks], f"{case}, JAX sharded",
                        energy_rtol)
    _assert_step_agrees(got, single, f"{case}, JAX single-device",
                        energy_rtol)
