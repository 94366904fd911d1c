"""Rank functions for the port's multi-process CPU tests
(``tests/test_torch_{parallel,sharded_step,sharded_epoch}.py``): each test file spawns
its ranks once per rank count with ``spawn``, every rank joins a gloo group
through a ``file://`` rendezvous in the test's temporary directory (so
concurrent test workers never share a port) with one torch thread, runs
every case of its file and saves what it got to ``<out>/<case>_<rank>.pt``
for the test process to compare. This module imports no JAX: the ranks
start from a fresh interpreter and import it by name."""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, nprocs: int, out_dir, *args):
    """Start ``fn(rank, nprocs, rendezvous, out_dir, *args)`` on ``nprocs``
    gloo ranks; returns the spawn context (``join()`` until it is True)."""
    rendezvous = "file://" + os.path.join(str(out_dir), "rendezvous")
    return mp.spawn(fn, args=(nprocs, rendezvous, str(out_dir)) + args,
                    nprocs=nprocs, join=False)


def join(ctx, timeout: float = 300.0):
    """Wait for every rank of ``ctx`` (a rank's failure raises here); past
    ``timeout`` seconds the ranks are ended and TimeoutError raised."""
    deadline = time.monotonic() + timeout
    while not ctx.join(max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"ranks still running after {timeout} s")


def load(out_dir, case: str, nprocs: int) -> list:
    """Every rank's saved result of ``case``, by rank."""
    return [torch.load(os.path.join(str(out_dir), f"{case}_{r}.pt"))
            for r in range(nprocs)]


def _init(rank, nprocs, rendezvous):
    from climsim_tpu_torch.parallel import init_distributed
    torch.set_num_threads(1)
    init_distributed(rendezvous, nprocs, rank, device="cpu")


def _save(out_dir, case, rank, obj):
    torch.save(obj, os.path.join(out_dir, f"{case}_{rank}.pt"))


def _raises(fn) -> str | None:
    """The message of the ValueError ``fn()`` raises, else None."""
    try:
        fn()
    except ValueError as err:
        return str(err)
    return None


# ---------------------------------------------------------------- parallel

HALO_ROWS = 16      # the global rows the halo cases shard


def halo_input() -> np.ndarray:
    return np.random.default_rng(5).normal(0, 1, (HALO_ROWS, 3))


def parallel_ranks(rank, nprocs, rendezvous, out_dir):
    """Meshes, halo exchanges (width 1 and 2, periodic or not, blocking and
    started), a sharded stencil, global sums, shard_batch and replicate."""
    from climsim_tpu_torch.parallel import (axis_rank, exchange_halo,
                                            global_sum, make_global_mesh,
                                            make_mesh, make_mesh_2d,
                                            replicate, shard_batch,
                                            sharded_stencil)
    _init(rank, nprocs, rendezvous)
    try:
        mesh = make_mesh(nprocs, axis="col")
        res = {"names": mesh.mesh_dim_names,
               "axis_rank": axis_rank(mesh, "col")}
        xs = shard_batch(mesh, torch.as_tensor(halo_input()), axis="col")
        res["shard"] = xs
        for width in (1, 2):
            for periodic in (False, True):
                res[f"halo_{width}_{periodic}"] = exchange_halo(
                    xs, mesh, "col", width, periodic)
                res[f"halo_{width}_{periodic}_async"] = exchange_halo(
                    xs, mesh, "col", width, periodic, async_op=True).wait()
        res["stencil"] = sharded_stencil(
            lambda xh: 0.25 * xh[:-2] + 0.5 * xh[1:-1] + 0.25 * xh[2:],
            mesh, "col", 1)(xs)
        res["sum"] = global_sum(torch.tensor([rank + 1.0, 2.0]), mesh, "col")
        res["shard_error"] = _raises(lambda: shard_batch(
            mesh, torch.zeros(nprocs + 1), axis="col"))
        res["mesh_error"] = _raises(lambda: make_mesh(nprocs + 1))
        lin = torch.nn.Linear(2, 3)
        with torch.no_grad():
            lin.weight.fill_(rank)
            lin.bias.fill_(-rank)
        tree = {"w": torch.full((3,), float(rank)),
                "nested": [torch.arange(4.0) * rank]}
        replicate(mesh, tree)
        replicate(mesh, lin)
        res["replicated"] = (tree["w"], tree["nested"][0],
                             lin.weight.detach(), lin.bias.detach())
        res["global_names"] = make_global_mesh().mesh_dim_names
        m2 = make_mesh_2d(2, nprocs // 2)
        res["mesh_2d"] = (m2.mesh_dim_names, tuple(m2.mesh.shape),
                          axis_rank(m2, "data"), axis_rank(m2, "ensemble"))
        _save(out_dir, "parallel", rank, res)
    finally:
        dist.destroy_process_group()


def data_parallel_ranks(rank, nprocs, rendezvous, out_dir, kernel, bias, x,
                        y, lr, steps):
    """``data_parallel_step`` on a flax-layout Dense with Adam: ``steps``
    steps on this rank's block of (x, y); saves the losses and the
    parameters."""
    from climsim_tpu_torch.models.cells import Dense
    from climsim_tpu_torch.parallel import (data_parallel_step, make_mesh,
                                            replicate, shard_batch)
    _init(rank, nprocs, rendezvous)
    try:
        mesh = make_mesh(nprocs, axis="data")
        model = Dense(kernel.shape[0], kernel.shape[1], torch.float32)
        with torch.no_grad():
            model.kernel.copy_(torch.as_tensor(kernel))
            model.bias.copy_(torch.as_tensor(bias))
        replicate(mesh, model)
        opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                               eps=1e-8)
        mse = lambda pred, yy: torch.mean((pred - yy) ** 2)
        step = data_parallel_step(model, opt, mse, mesh, "data")
        xl, yl = shard_batch(mesh, torch.as_tensor(x), torch.as_tensor(y),
                             axis="data")
        losses = [float(step(xl, yl)) for _ in range(steps)]
        _save(out_dir, "data_parallel", rank,
              {"losses": losses, "kernel": model.kernel.detach(),
               "bias": model.bias.detach()})
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- sharded step

NLAT, NLON = 16, 24
XSCALE = [250.0, 1e-3, 1e-5, 1e-5, 10.0, 10.0]
YSCALE = [1e-5, 1e-9, 1e-10, 1e-10, 1e-5, 1e-5]
EMULATOR = dict(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(16, 16), nh_mem=4,
                add_pres=False, output_prune=False)
PROD = dict(scheme="fv", geometry="sphere", fix_water=True, fix_energy=True)
# case -> (HostLoopConfig fields, overlap); the flat raster's cells: 100 km
# for FV and vertical transport, 20 km for semi-Lagrangian transport, where
# a departure moves 0.6 of a cell at 10 m/s and no meridional one leaves the
# halo
SHARDED_CASES = {
    "production_overlap": (PROD, True),
    "production_exchange": (PROD, False),
    "vertical_sphere": (dict(PROD, vertical_advection=True), True),
    "vertical_flat": (dict(PROD, geometry="flat", vertical_advection=True,
                           dx=1e5, dy=1e5), True),
    "sl_sphere": (dict(PROD, scheme="semi_lagrangian"), True),
    "sl_flat": (dict(PROD, scheme="semi_lagrangian", geometry="flat",
                     dx=2e4, dy=2e4), True),
    "no_transport": (dict(PROD, scheme="none"), True),
}


def port_emulator(params):
    """The scan-arm RNNAutoreg on the flax parameters, wrapped as
    tests/test_online.py wraps JAX's: normalise -> model -> scale."""
    from climsim_tpu_torch.models import F32, RNNAutoreg, from_flax_params
    model = RNNAutoreg(policy=F32, device="cpu", **EMULATOR)
    model.load_state_dict(from_flax_params(params, model))
    xs, ys = torch.tensor(XSCALE), torch.tensor(YSCALE)

    def emulator(x_main_raw, x_sfc_raw, mem):
        out, out_sfc, mem = model(x_main_raw / xs, x_sfc_raw, mem)
        return out * ys, out_sfc, mem

    return emulator


def sharded_ranks(rank, nprocs, rendezvous, out_dir, params, state, mem,
                  x_sfc, cases, errors):
    """The SHARDED_CASES ``cases`` of ``sharded_hybrid_step`` on this rank's
    latitude band of the global columns (state [ncol, nlev] per field,
    mem [ncol, nlev, nm], x_sfc [ncol, ns]); then, with ``errors``, the
    ValueErrors."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.online import (HostLoopConfig, HybridLoop,
                                          sharded_hybrid_step, to_grid)
    from climsim_tpu_torch.parallel import make_mesh
    _init(rank, nprocs, rendezvous)
    try:
        mesh = make_mesh(nprocs, axis="col")
        emulator = port_emulator(params)
        grid = Grid.synthetic(NLAT * NLON, state["T"].shape[1])
        n = NLAT // nprocs
        rows = slice(rank * n, (rank + 1) * n)
        t = lambda a: torch.as_tensor(a)
        for case in cases:
            over, overlap = SHARDED_CASES[case]
            cfg = HostLoopConfig(**dict(over, nlat=NLAT, nlon=NLON))
            loop = HybridLoop(emulator, grid, cfg, device="cpu")
            tog = lambda a: to_grid(t(a), loop.gather_idx, NLAT, NLON)[rows]
            local = ({k: tog(v) for k, v in state.items()},
                     t(mem)[loop.gather_idx][rank * n * NLON:
                                             (rank + 1) * n * NLON],
                     tog(x_sfc))
            step = sharded_hybrid_step(loop, mesh, overlap=overlap)
            with torch.no_grad():
                out, mem_new, diags = step(*local)
            _save(out_dir, case, rank, {"state": out, "mem": mem_new,
                                        "diags": diags})
        if not errors:
            return
        base = dict(PROD, nlat=NLAT, nlon=NLON)
        raised = {
            "level_major": _raises(lambda: sharded_hybrid_step(HybridLoop(
                emulator, grid, HostLoopConfig(**base,
                                               emulator_level_major=True),
                device="cpu"), mesh)),
            "feature_builder": _raises(lambda: sharded_hybrid_step(
                HybridLoop(emulator, grid, HostLoopConfig(**base),
                           feature_builder=lambda s, x: (s, x),
                           device="cpu"), mesh)),
            # 384 columns as 3 x 128 bands: 3 rows divide over no 2 or 4
            "rows_undivided": _raises(lambda: sharded_hybrid_step(HybridLoop(
                emulator, grid, HostLoopConfig(**dict(base, nlat=3,
                                                      nlon=128)),
                device="cpu"), mesh)),
            # one row a rank, fewer than the halo's 2
            "rows_below_halo": _raises(lambda: sharded_hybrid_step(
                HybridLoop(emulator, grid, HostLoopConfig(**dict(
                    base, nlat=nprocs, nlon=NLAT * NLON // nprocs)),
                    device="cpu"), mesh)),
        }
        _save(out_dir, "errors", rank, raised)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- sharded epoch

EPOCH_L, EPOCH_T, EPOCH_B = 20, 8, 16
# case -> RolloutConfig fields; W 2 on chunks of 4 steps: 4 updates
EPOCH_CASES = {
    "base": dict(loss="mse", rollout_schedule={0: 2}, lr=1e-3),
    # the terms that are not means of per-column terms: the bias
    # penalty's batch means and the GEL exponent; with w_precip and remat
    "bias": dict(loss="huber", rollout_schedule={0: 2}, lr=1e-3, w_bias=0.5,
                 w_gel_precip=0.1, w_precip=0.01, remat=True),
    # the replay mask drawn over the global batch, then sliced
    "mixed": dict(loss="mse", rollout_schedule={0: 2}, lr=1e-3,
                  replay="mixed", replay_slice=(0, 3), pred_slice=(0, 3),
                  gradual_mixing_end_epoch=2),
    # a 3-member ensemble of the stochastic model (seeded weights): the
    # memory [M, B, ...] split on axis 1, each member's noise drawn for
    # the global batch and sliced; AR(1) noise through each W 2 window
    "ensemble": dict(loss="mse", rollout_schedule={0: 2}, lr=1e-3,
                     ensemble_size=3, w_det=0.1),
}


def epoch_hybrid():
    """The hybrid coefficients of the epoch cases' EPOCH_L levels."""
    return (np.linspace(2e-3, 0.0, EPOCH_L + 1).astype(np.float32),
            np.linspace(0.0, 1.0, EPOCH_L + 1).astype(np.float32))


def epoch_data(B=EPOCH_B, seed=21):
    """A [T, B, ...] keeplev series: normalized-scale inputs, targets a
    smooth function of them, surface pressure in Pa."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    xl = f(rng.normal(0, 1, (EPOCH_T, B, EPOCH_L, 6)))
    xs = f(rng.normal(0, 1, (EPOCH_T, B, 24)))
    return {"x_lev": xl, "x_sfc": xs, "y_lev": f(0.5 * np.tanh(xl)),
            "y_sfc": f(np.abs(xs[..., :8])),
            "sp": f(rng.uniform(9.6e4, 1.03e5, (EPOCH_T, B)))}


def epoch_chunks(data):
    from climsim_tpu_torch.data import keeplev_chunks
    return keeplev_chunks(data["x_lev"], data["x_sfc"], data["y_lev"],
                          data["y_sfc"], data["sp"], chunk_size=4,
                          shuffle=False)


def epoch_trainer(params, case):
    """The scan-arm RNNAutoreg of the dry run on the flax parameters (for
    the ensemble case its stochastic twin, weights from a seed) and its
    RolloutTrainer for ``case``, on the CPU."""
    from climsim_tpu_torch.models import F32, RNNAutoreg, from_flax_params
    from climsim_tpu_torch.train import RolloutConfig, RolloutTrainer
    if case == "ensemble":
        model = RNNAutoreg(policy=F32, device="cpu", seed=5,
                           add_stochastic_layer=True, ar_noise_rho=0.9,
                           **EMULATOR)
    else:
        model = RNNAutoreg(policy=F32, device="cpu", **EMULATOR)
        model.load_state_dict(from_flax_params(params, model))
    return RolloutTrainer(model, RolloutConfig(**EPOCH_CASES[case]),
                          *epoch_hybrid(), yscale_lev=np.ones((1, 1, 6)),
                          yscale_sca=np.ones(8), device="cpu")


def run_epoch(params, case, mesh=None):
    """One fused epoch of ``case`` on epoch_data: (record, parameters,
    memory)."""
    from climsim_tpu_torch.train.rollout import run_epoch_fused
    tr = epoch_trainer(params, case)
    mem, rec = run_epoch_fused(tr, None, epoch_chunks(epoch_data()), 0,
                               mesh=mesh)
    return rec, {k: v.detach().clone() for k, v
                 in tr.model.state_dict().items()}, mem


def sharded_epoch_ranks(rank, nprocs, rendezvous, out_dir, params):
    """Every EPOCH_CASES case's data-parallel fused epoch on this rank's
    block of the columns; then the ValueError of a batch that does not
    divide over the ranks."""
    from climsim_tpu_torch.parallel import make_mesh
    from climsim_tpu_torch.train.rollout import run_epoch_fused
    _init(rank, nprocs, rendezvous)
    try:
        mesh = make_mesh(nprocs, axis="data")
        for case in EPOCH_CASES:
            rec, state, mem = run_epoch(params, case, mesh)
            _save(out_dir, case, rank, {"rec": rec, "params": state,
                                        "mem": mem})
        odd = epoch_data(B=nprocs + 1)
        _save(out_dir, "errors", rank, _raises(lambda: run_epoch_fused(
            epoch_trainer(params, "base"), None, epoch_chunks(odd), 0,
            mesh=mesh)))
    finally:
        dist.destroy_process_group()
