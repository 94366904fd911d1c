"""Online hybrid simulation CLI: run the coupled emulator + transport host
loop (the ClimSim-Online 'run the hybrid simulation' step,
online_testing/README.md §5, without the Fortran host).

Counterpart of ``climsim_tpu/cli/run_hybrid.py``, with the same flags and
defaults but three:

* ``--device`` (default ``cuda``) takes the place of ``--platform``: the
  CLI runs on the card and raises without one unless asked for
  ``--device cpu``;
* ``--checkpoint`` takes a file written by ``torch.save(model.
  state_dict())`` of the model this CLI builds (JAX's orbax checkpoints
  cross over through ``models.convert.from_flax_params``);
* ``--grid`` defaults to the grid file's place in the ClimSim repository
  (``DEFAULT_GRID``), relative to the working directory, where the JAX
  CLI names an absolute path.

Usage:
    python -m climsim_tpu_torch.cli.run_hybrid [--steps 48] [--scheme fv]
        [--checkpoint FILE] [--device cuda] [--grid FILE] [--out diags.npz]

Without a checkpoint a randomly-initialized emulator runs (smoke mode),
its tendencies damped by 1e-6 to plausible magnitudes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data import synthetic as S
from ..grid import Grid
from ..models.rnn import RNNAutoreg
from ..online import HostLoopConfig, HybridLoop
from ..ops import resolve_device

PROGNOSTIC = ("T", "qv", "qc", "qi", "u", "v")
# the ClimSim low-res grid file, at its place in the ClimSim repository's
# tree, relative to the directory the CLI runs from
DEFAULT_GRID = "grid_info/ClimSim_low-res_grid-info.nc"
# the surface inputs the CLI feeds; the other 17 of the model's 24 are 0
SFC_FIELDS = ("state_ps", "pbuf_SOLIN", "pbuf_LHFLX", "pbuf_SHFLX",
              "pbuf_TAUX", "pbuf_TAUY", "pbuf_COSZRS")


def build_model(grid: Grid, nneur: int, nh_mem: int, device,
                seed: int = 1) -> RNNAutoreg:
    """The JAX CLI's emulator: the batch-major scan arm in F32 with the
    grid's hybrid coefficients, no pressure feature, its weights from
    ``seed``."""
    tt = lambda a: tuple(float(x) for x in a.detach().cpu().numpy())
    return RNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(nneur, nneur),
                      nh_mem=nh_mem, hyam=tt(grid.hyam), hybm=tt(grid.hybm),
                      sp_mean=0.0, sp_div=1.0, add_pres=False,
                      output_prune=True, device=device, seed=seed)


def initial_state(grid: Grid, generator: torch.Generator | None = None):
    """The synthetic v1 state in raw units on the grid's device, its noise
    from ``generator`` (a CPU ``torch.Generator``): the six prognostic
    fields [ncol, nlev] and x_sfc [ncol, 24] (SFC_FIELDS, then zeros)."""
    s0 = S.generate_state(generator, S.SyntheticConfig(vset_name="v1"),
                          grid)
    state = dict(zip(PROGNOSTIC, (s0["state_t"], s0["state_q0001"],
                                  s0["state_q0002"], s0["state_q0003"],
                                  s0["state_u"], s0["state_v"])))
    ps = s0["state_ps"]
    x_sfc = torch.stack([s0[k] for k in SFC_FIELDS]
                        + [torch.zeros_like(ps)] * 17, dim=1)
    return state, x_sfc


def run(model: RNNAutoreg, grid: Grid, state: dict, x_sfc: torch.Tensor,
        steps: int, scheme: str = "fv", damp: float = 1e-6, device=None):
    """``steps`` coupled steps of ``model`` (tendencies times ``damp``) in
    ``HybridLoop(HostLoopConfig(scheme=scheme))`` from zero memory.
    Returns (final state, memory, diagnostics, wall seconds, taken after
    the card has finished)."""
    dev = resolve_device(device)

    def emulator(x_main, x_sfc_in, mem):
        out, out_sfc, mem = model(x_main, x_sfc_in, mem)
        return out * damp, out_sfc * damp, mem

    loop = HybridLoop(emulator, grid, HostLoopConfig(scheme=scheme),
                      device=dev)
    mem0 = torch.zeros((grid.ncol, grid.nlev, model.nh_mem),
                       dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        final, mem, diags = loop.rollout(state, mem0, x_sfc, steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return final, mem, diags, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=48)
    p.add_argument("--scheme", default="fv",
                   choices=["fv", "semi_lagrangian", "none"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--nneur", type=int, default=192)
    p.add_argument("--nh-mem", type=int, default=16)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--grid", default=DEFAULT_GRID)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    grid = Grid.from_file(args.grid, device=device)
    model = build_model(grid, args.nneur, args.nh_mem, device)
    if args.checkpoint:
        model.load_state_dict(torch.load(args.checkpoint,
                                         map_location=device))
    state, x_sfc = initial_state(grid, torch.Generator().manual_seed(0))
    # tendencies in raw units: the random emulator's outputs are O(1); damp
    # to physically-plausible magnitudes in smoke mode
    damp = 1e-6 if not args.checkpoint else 1.0
    final, _, diags, dt = run(model, grid, state, x_sfc, args.steps,
                              args.scheme, damp, device)
    mt = diags["mean_T"].cpu().numpy()
    print(f"hybrid rollout: {args.steps} coupled steps "
          f"({args.steps * 20 / 60:.1f} sim-hours), wall {dt:.2f}s")
    print(f"mean T trajectory: start={mt[0]:.3f} K end={mt[-1]:.3f} K")
    finite = all(bool(torch.isfinite(v).all()) for v in final.values())
    print(f"finite: {finite}")
    if args.out:
        np.savez(args.out, mean_T=mt, precc=diags["precc"].cpu().numpy(),
                 **{k: v.cpu().numpy() for k, v in final.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
