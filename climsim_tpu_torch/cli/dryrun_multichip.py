"""Multi-device dry run: one data-parallel training step of the MLP
baseline, the latitude-sharded production coupled step with a real
emulator held against the single-device step, and one data-parallel
rollout-training epoch, on N ranks (counterpart of
``__graft_entry__.py::dryrun_multichip``).

Usage:
    python -m climsim_tpu_torch.cli.dryrun_multichip --devices N \\
        [--device cpu] [--grid FILE]

JAX runs one controller over N (virtual) devices; here N ranks are
spawned (``torch.multiprocessing``, a ``file://`` rendezvous in a
temporary directory), NCCL ranks on the cards (one card a rank) by
default and gloo ranks with ``--device cpu``. Each rank runs:

1. ``mlp_for(v1, (64, 64))`` with ``train.loop``'s FitConfig and
   ``init_state``, one step of ``parallel.data_parallel_step`` on its
   block of a batch of 8 N columns (ones in, zeros out);
2. ``online.sharded_hybrid_step`` in the production configuration
   (spherical FV, both fixers) on a 2N x 384/(2N) proxy grid of the grid
   file (``--grid``, by default ``run_hybrid.DEFAULT_GRID`` relative to
   the working directory), the emulator the small scan-arm
   ``RNNAutoreg`` (nneur 16, nh_mem 4) from seed 7; its rows must equal
   ``coupled_step``'s on the whole grid (fields rtol 1e-5 / atol 5e-7,
   JAX's bound);
3. ``train.rollout.run_epoch_fused(mesh=)`` of the same model, W 2, on a
   4-step chunk of 8 N columns.

Rank 0 prints JAX's lines (``dryrun_multichip(N): dp train loss=... OK``
and the others). JAX's fourth part, ensemble-parallel RPN training on a
(data, ensemble) mesh, waits for the RPN model (ROADMAP A.13, the
stochastic stack). Any failed check raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

NLEV = 60
XSCALE = [250.0, 1e-3, 1e-5, 1e-5, 10.0, 10.0]
YSCALE = [1e-5, 1e-9, 1e-10, 1e-10, 1e-5, 1e-5]
EMULATOR = dict(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(16, 16), nh_mem=4,
                add_pres=False, output_prune=False)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _close(got, want, rtol, atol, what):
    err = (got - want).abs() - rtol * want.abs()
    _check(bool((err <= atol).all()), f"{what}: sharded differs from the "
           f"single-device step by {float(err.max()) + atol:.3e}")


def dp_train_step(n, dev, mesh):
    """Part 1: returns the global mean loss of one data-parallel step."""
    from .. import variables as V
    from ..models import mlp_for
    from ..parallel import data_parallel_step, replicate, shard_batch
    from ..train import FitConfig, init_state
    from ..train import losses as L

    vs = V.get("v1")
    cfg = FitConfig(lr=1e-3)
    state = init_state(mlp_for(vs, features=(64, 64), device=dev), cfg)
    replicate(mesh, state.model)
    feat_w = torch.as_tensor(L.block_weights(vs, cfg.var_weights),
                             device=dev)
    step = data_parallel_step(
        state.model, state.opt,
        lambda pred, y: L.weighted_loss(pred, y, feat_w, cfg.loss), mesh)
    batch = 8 * n
    x = torch.ones((batch, vs.input_feature_len), device=dev)
    y = torch.zeros((batch, vs.target_feature_len), device=dev)
    loss = float(step(*shard_batch(mesh, x, y)))
    _check(np.isfinite(loss), "non-finite loss in the dp train step")
    return loss


def emulator_model(dev):
    from ..models import F32, RNNAutoreg
    return RNNAutoreg(policy=F32, device=dev, seed=7, **EMULATOR)


def sharded_step(rank, n, dev, grid_path, rng):
    """Part 2: this rank's band of the sharded production step against
    the single-device coupled step; returns mean_T."""
    from ..grid import Grid
    from ..online import HostLoopConfig, HybridLoop, to_grid
    from ..online.host_loop import sharded_hybrid_step
    from ..parallel import make_mesh

    model = emulator_model(dev)
    xs = torch.tensor(XSCALE, device=dev)
    ys = torch.tensor(YSCALE, device=dev)

    def emulator(x_main, x_sfc, mem):
        out, out_sfc, mem = model(x_main / xs, x_sfc, mem)
        return out * ys, out_sfc, mem

    grid = Grid.from_file(grid_path, device=dev)
    nlat, nlon = 2 * n, grid.ncol // (2 * n)
    cfg = HostLoopConfig(scheme="fv", fix_water=True, fix_energy=True,
                         nlat=nlat, nlon=nlon)
    loop = HybridLoop(emulator, grid, cfg, device=dev)
    ncol = grid.ncol
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    state = {"T": f32(rng.uniform(230, 300, (ncol, NLEV))),
             "qv": f32(np.abs(rng.normal(1e-3, 1e-4, (ncol, NLEV)))),
             "qc": torch.zeros((ncol, NLEV), device=dev),
             "qi": torch.zeros((ncol, NLEV), device=dev),
             "u": f32(rng.normal(0, 5, (ncol, NLEV))),
             "v": f32(rng.normal(0, 2, (ncol, NLEV)))}
    x_sfc = torch.cat([torch.full((ncol, 1), 1e5, device=dev),
                       torch.ones((ncol, 23), device=dev)], dim=1)
    mem = torch.zeros((ncol, NLEV, 4), device=dev)
    rows = slice(rank * 2, rank * 2 + 2)
    tog = lambda a: to_grid(a, loop.gather_idx, nlat, nlon)[rows]
    block = slice(rank * 2 * nlon, (rank + 1) * 2 * nlon)
    step = sharded_hybrid_step(loop, make_mesh(n, axis="col"))
    with torch.no_grad():
        out, out_mem, diags = step({k: tog(v) for k, v in state.items()},
                                   mem[loop.gather_idx][block], tog(x_sfc))
        want, want_mem, _ = loop.coupled_step(state, mem, x_sfc)
    mean_t = float(diags["mean_T"])
    _check(np.isfinite(mean_t), "non-finite mean_T")
    for k in state:
        _close(out[k], tog(want[k]), 1e-5, 5e-7, k)
    _close(out_mem, want_mem[loop.gather_idx][block], 1e-5, 5e-7, "memory")
    return mean_t


def dp_rollout_epoch(n, dev, grid_path, rng):
    """Part 3: returns the record's loss of one data-parallel fused
    epoch."""
    from ..data import keeplev_chunks
    from ..grid import Grid
    from ..parallel import make_mesh, replicate
    from ..train.rollout import (RolloutConfig, RolloutTrainer,
                                 run_epoch_fused)

    grid = Grid.from_file(grid_path, device="cpu")
    model = emulator_model(dev)
    mesh = make_mesh(n, axis="data")
    replicate(mesh, model)
    T, B = 4, 8 * n
    f32 = lambda a: np.asarray(a, np.float32)
    xl = f32(rng.normal(0, 1, (T, B, NLEV, 6)))
    xsf = f32(rng.normal(0, 1, (T, B, 24)))
    yl, ysf = f32(np.tanh(xl)), f32(np.abs(xsf[..., :8]))
    sp = f32(rng.uniform(9.6e4, 1.03e5, (T, B)))
    tr = RolloutTrainer(model, RolloutConfig(rollout_schedule={0: 2},
                                             lr=1e-3),
                        grid.hyai.numpy(), grid.hybi.numpy(),
                        yscale_lev=np.ones((1, 1, 6)), yscale_sca=np.ones(8),
                        device=dev)
    _, rec = run_epoch_fused(tr, None, keeplev_chunks(
        xl, xsf, yl, ysf, sp, chunk_size=4, shuffle=False), 0, mesh=mesh)
    _check(np.isfinite(rec["loss"]), "non-finite dp rollout loss")
    return rec["loss"]


def _rank(rank, n, device, grid_path, rendezvous):
    import torch.distributed as dist
    from ..parallel import init_distributed, local_device, make_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    else:
        os.environ["LOCAL_RANK"] = str(rank)
    init_distributed(rendezvous, n, rank, device=device)
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        dev = local_device(device)
        loss = dp_train_step(n, dev, make_mesh(n, axis="data"))
        say(f"dryrun_multichip({n}): dp train loss={loss:.4f} OK",
            flush=True)
        # one generator for parts 2 and 3, as JAX's dry run draws them
        rng = np.random.default_rng(0)
        mean_t = sharded_step(rank, n, dev, grid_path, rng)
        say(f"dryrun_multichip({n}): sharded hybrid step (REAL RNNAutoreg "
            f"emulator) mean_T={mean_t:.2f} == single-device OK", flush=True)
        loss = dp_rollout_epoch(n, dev, grid_path, rng)
        say(f"dryrun_multichip({n}): dp rollout train loss={loss:.4f} OK",
            flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    from .run_hybrid import DEFAULT_GRID
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--grid", default=DEFAULT_GRID)
    args = p.parse_args(argv)
    device = torch.device(args.device).type
    if device == "cuda" and args.devices > torch.cuda.device_count():
        raise RuntimeError(f"--devices {args.devices}: this machine has "
                           f"{torch.cuda.device_count()} CUDA devices (NCCL "
                           "takes one rank a device); --device cpu runs "
                           "gloo ranks")
    import torch.multiprocessing as mp
    from . import dryrun_multichip    # the ranks import the worker by name

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(dryrun_multichip._rank,
                 args=(args.devices, device, os.path.abspath(args.grid),
                       "file://" + os.path.join(tmp, "rendezvous")),
                 nprocs=args.devices, join=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
