"""Scaling benchmark: grid-points/s of the sharded hybrid step at 1..N
devices (the BASELINE.json scaling-efficiency metric).

Counterpart of ``climsim_tpu/cli/scale_bench.py``, with its flags, stub
emulator, state, ``HostLoopConfig(scheme="fv", fix_water=False)``, fake
grid and JSON lines. Two departures:

* JAX is one controller over a virtual mesh; PyTorch runs one process per
  device, so for each device count this CLI spawns that many ranks
  (``torch.multiprocessing``, a ``file://`` rendezvous in a temporary
  directory): NCCL ranks on the cards by default, gloo ranks on the CPU
  with ``--platform cpu``;
* the hybrid coefficients come from the grid file at
  ``run_hybrid.DEFAULT_GRID``, relative to the working directory, where the
  JAX CLI names an absolute path.

Usage:
    python -m climsim_tpu_torch.cli.scale_bench [--devices 1 2 4 8]
        [--nlat 64 --nlon 128 --nlev 60] [--steps 10] [--platform cpu]

On the cards it measures the sharded step with its halo exchange over
NVLink; on the CPU it checks the collective paths and reports relative
scaling, not absolute speed.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


class _FakeGrid:
    """A grid of nlat x nlon columns in latitude bands for the proxy
    mapping, with the mass weights of ``grid``'s hybrid coefficients."""

    def __init__(self, grid, nlat, nlon):
        self.lat = np.repeat(np.linspace(-88, 88, nlat), nlon)
        self.lon = np.tile(np.linspace(0, 360, nlon, endpoint=False), nlat)
        self.mass_weights = grid.mass_weights


def _emulator(x_main, x_sfc, mem):
    """The stub physics: warms T by 1e-5 K/s, nothing else."""
    B, L, _ = x_main.shape
    pt = torch.zeros((B, L, 6), device=x_main.device)
    pt[:, :, 0] = 1e-5
    return pt, torch.zeros((B, 8), device=x_main.device), mem


def _state(nlat, nlon, nlev):
    """The JAX CLI's state (np.random.default_rng(0)) in grid layout, on
    the host: fields [nlat, nlon, nlev], x_sfc [nlat, nlon, 24], mem
    [nlat * nlon, nlev, 4]."""
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    shape = (nlat, nlon, nlev)
    state = {"T": f32(rng.uniform(230, 300, shape)),
             "qv": f32(np.abs(rng.normal(1e-3, 1e-4, shape))),
             "qc": torch.zeros(shape), "qi": torch.zeros(shape),
             "u": f32(rng.normal(0, 5, shape)),
             "v": f32(rng.normal(0, 2, shape))}
    x_sfc = torch.cat([torch.full((nlat, nlon, 1), 1e5),
                       torch.ones((nlat, nlon, 23))], dim=-1)
    return state, x_sfc, torch.zeros((nlat * nlon, nlev, 4))


def _rank(rank, nd, args, rendezvous, out_path):
    """One rank of an ``nd``-device run: its latitude band, a warm-up step
    and ``args.steps`` timed steps; rank 0 writes their seconds to
    ``out_path``."""
    import torch.distributed as dist
    from ..grid import Grid
    from ..online import HostLoopConfig, HybridLoop
    from ..online.host_loop import sharded_hybrid_step
    from ..parallel import init_distributed, local_device, make_mesh
    from .run_hybrid import DEFAULT_GRID

    cpu = args.platform == "cpu"
    if cpu:
        # one core a rank, so that n ranks are n devices' worth of compute
        torch.set_num_threads(1)
    else:
        os.environ["LOCAL_RANK"] = str(rank)
    device = "cpu" if cpu else None
    init_distributed(rendezvous, nd, rank, device=device)
    try:
        dev = local_device(device)
        nlat, nlon, nlev = args.nlat, args.nlon, args.nlev
        grid = Grid.from_file(DEFAULT_GRID, device=dev)
        cfg = HostLoopConfig(scheme="fv", fix_water=False, nlat=nlat,
                             nlon=nlon)
        loop = HybridLoop(_emulator, _FakeGrid(grid, nlat, nlon), cfg,
                          device=dev)
        mesh = make_mesh(nd, axis="col")
        step = sharded_hybrid_step(loop, mesh)
        n = nlat // nd
        rows = slice(rank * n, (rank + 1) * n)
        state, x_sfc, mem = _state(nlat, nlon, nlev)
        state = {k: v[rows].to(dev) for k, v in state.items()}
        x_sfc = x_sfc[rows].to(dev)
        mem = mem[rank * n * nlon:(rank + 1) * n * nlon].to(dev)
        with torch.no_grad():
            out = step(state, mem, x_sfc)
            float(out[2]["mean_T"])
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                out = step(state, mem, x_sfc)
            float(out[2]["mean_T"])
            dt = time.perf_counter() - t0
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"seconds": dt}, f)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--nlat", type=int, default=64)
    p.add_argument("--nlon", type=int, default=128)
    p.add_argument("--nlev", type=int, default=60)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)
    if args.platform not in (None, "cpu", "cuda", "gpu"):
        raise ValueError(f"--platform {args.platform!r}: cpu or cuda")
    if args.platform != "cpu":
        have = torch.cuda.device_count()
        if max(args.devices) > have:
            raise RuntimeError(f"--devices {max(args.devices)}: this machine "
                               f"has {have} CUDA devices (NCCL takes one "
                               "rank a device); --platform cpu runs gloo "
                               "ranks")

    import torch.multiprocessing as mp
    from . import scale_bench    # the ranks import the worker by name

    gridpoints = args.nlat * args.nlon * args.nlev
    results = {}
    for nd in args.devices:
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "rank0.json")
            rendezvous = "file://" + os.path.join(tmp, "rendezvous")
            mp.spawn(scale_bench._rank, args=(nd, args, rendezvous, out_path),
                     nprocs=nd, join=True)
            with open(out_path) as f:
                dt = json.load(f)["seconds"]
        gps = gridpoints * args.steps / dt
        results[nd] = gps
        eff = gps / (results[args.devices[0]] * nd / args.devices[0])
        print(json.dumps({"devices": nd, "gridpoints_per_s": round(gps),
                          "scaling_efficiency": round(eff, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
