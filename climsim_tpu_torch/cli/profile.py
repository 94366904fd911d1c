"""Profiling CLI: capture a host and device trace of the emulator's step
(counterpart of ``climsim_tpu/cli/profile.py``).

Usage:
    python -m climsim_tpu_torch.cli.profile --logdir climsim_trace
    python -m climsim_tpu_torch.cli.profile --device cpu --steps 5

It builds the JAX CLI's model (``RNNAutoreg`` scan arm, nx 15, nneur
192/192, nh_mem 16, f32) on the grid file ``cli.run_hybrid.DEFAULT_GRID``
(relative to the working directory), traces ``--steps`` forward calls
under ``utils.trace`` (a Chrome trace JSON under ``--logdir``), then
prints the device memory and the achieved FLOP/s. ``--device`` (default
the card) takes the place of JAX's ``--platform``. As in the JAX CLI the
forward is profiled whatever ``--what`` says.
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--what", default="forward",
                   choices=["forward", "rollout", "hybrid"])
    p.add_argument("--logdir", default="climsim_trace")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=1536)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    from ..grid import Grid
    from ..models.rnn import RNNAutoreg
    from ..ops import resolve_device
    from ..utils import annotate, device_memory_stats, trace
    from ..utils.observability import achieved_flops
    from .run_hybrid import DEFAULT_GRID

    dev = resolve_device(args.device)
    g = Grid.from_file(DEFAULT_GRID, device=dev)
    tt = lambda a: tuple(float(x) for x in a.tolist())
    model = RNNAutoreg(nx=15, nx_sfc=24, ny=6, ny_sfc=8, nneur=(192, 192),
                       nh_mem=16, hyam=tt(g.hyam), hybm=tt(g.hybm),
                       sp_mean=9.8e4, sp_div=1e4, device=dev)
    B, L = args.batch, 60
    xm = torch.ones((B, L, 15), device=dev)
    xs = torch.ones((B, 24), device=dev)
    mem = torch.zeros((B, L, 16), device=dev)
    with torch.no_grad():
        model(xm, xs, mem)  # first call outside the trace
        with trace(args.logdir, dev):
            for i in range(args.steps):
                with annotate(f"step_{i}"):
                    out = model(xm, xs, mem)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    del out

    print(f"trace written to {args.logdir} (view: chrome://tracing or "
          f"Perfetto)")
    for rec in device_memory_stats():
        print(rec)
    res = achieved_flops(model, xm, xs, mem, iters=args.steps)
    if res:
        print({k: (f"{v:.3e}" if isinstance(v, float) else v)
               for k, v in res.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
