"""Multi-device dry run: one data-parallel training step of the MLP
baseline, the latitude-sharded production coupled step with a real
emulator held against the single-device step, one data-parallel
rollout-training epoch, and with 4 or more ranks (an even number) one
ensemble-parallel RPN training step, on N ranks (counterpart of
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
   4-step chunk of 8 N columns;
4. where N >= 4 and even, ``ensemble_step``: ``RPNEnsemble(out_dim 8,
   features (16, 16), 4 members)`` on a ``make_mesh_2d(N / 2, 2)``
   (data, ensemble) mesh, each rank holding its ensemble block's members
   and its data block's rows of a batch of 8 N; one Adam step with the
   gradients averaged over the rank's data group in one ``all_reduce``;
   the loss is the mean over every member and row (the ranks' shares
   summed); the members must equal those of the same step on one device
   (bit for bit at world size 1).

Rank 0 prints JAX's lines (``dryrun_multichip(N): dp train loss=... OK``
and the others). The steps are SPMD: every rank runs its part and holds
its blocks, where JAX's one controller holds global arrays. Any failed
check raises.
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


def ensemble_step(n_data, n_ens, dev, rng, members=4):
    """Part 4 on a (``n_data``, ``n_ens``) mesh of every rank: returns the
    global loss of one ensemble-parallel Adam step. This rank's members
    are held to the same step of the whole ensemble on the whole batch:
    the gradient averaged over the data group, before the step, against
    the matching members' slice of the whole ensemble's gradient, then
    the weights after the step. Where the mesh has one rank both are
    equal bits; else the gradient lies within rtol 1e-6 plus 1e-6 of the
    tensor's largest |g| (the all-reduce sums in another order), and the
    weights within rtol 1e-6 plus 1e-3 of the learning rate."""
    import torch.distributed as dist
    from ..models import RPNEnsemble
    from ..parallel import axis_rank, make_mesh_2d, shard_batch
    from ..train.loop import zero_missing_grads_

    lr = 1e-3
    mesh = make_mesh_2d(n_data, n_ens)
    batch = 8 * n_data * n_ens
    x = torch.as_tensor(rng.normal(0, 1, (batch, 12)), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(np.tanh(rng.normal(0, 1, (batch, 8))),
                        dtype=torch.float32, device=dev)
    whole = RPNEnsemble(12, 8, features=(16, 16), num_members=members,
                        device=dev, seed=1)
    e, _ = axis_rank(mesh, "ensemble")
    per = members // n_ens
    mine = whole.member_block(e * per, (e + 1) * per)
    one = dist.get_world_size() == 1

    def backward(model, loss_fn):
        with torch.enable_grad():
            loss = loss_fn()
            loss.backward()
        return zero_missing_grads_(list(model.parameters())), loss.detach()

    def close(got, want, atol):
        return torch.equal(got, want) if one else bool(
            ((got - want).abs() <= 1e-6 * want.abs() + atol).all())

    xb, yb = shard_batch(mesh, x, y, axis="data")
    # this rank's share of the mean over every member and row
    grads, loss = backward(mine, lambda: mine.loss(xb, yb) * (per / members))
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.get_group("data"))
    flat /= n_data
    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(f.view_as(g))
    dist.all_reduce(loss)
    loss /= n_data
    _, want_loss = backward(whole, lambda: whole.loss(x, y))
    for (k, p), w in zip(mine.named_parameters(), whole.parameters()):
        want = w.grad[e * per:(e + 1) * per]
        _check(close(p.grad, want, 1e-6 * float(want.abs().max())),
               f"ensemble step: the gradient of {k} differs from the "
               "single-device step's")
    for model in (mine, whole):
        torch.optim.Adam(model.parameters(), lr=lr).step()
    want = whole.member_block(e * per, (e + 1) * per).state_dict()
    for k, v in mine.state_dict().items():
        _check(close(v, want[k], 1e-3 * lr),
               f"ensemble step: {k} differs from the single-device step")
    _check(torch.equal(loss, want_loss) if one else
           abs(float(loss) - float(want_loss)) <= 1e-6 * abs(float(want_loss)),
           f"ensemble loss {float(loss)!r} against {float(want_loss)!r}")
    return float(loss)


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
        if n >= 4 and n % 2 == 0:
            loss = ensemble_step(n // 2, 2, dev, rng)
            say(f"dryrun_multichip({n}): ensemble-parallel (data={n // 2} "
                f"x ens=2) loss={loss:.4f} OK", flush=True)
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
