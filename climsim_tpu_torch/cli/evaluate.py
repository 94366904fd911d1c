"""Offline evaluation CLI, the per-trial scoring script (counterpart of
``climsim_tpu/cli/evaluate.py``): load input/target/prediction arrays,
recover raw ps, apply the unscale -> dp/g -> area -> energy weighting
chain, and write the per-variable (and per-level) metric CSVs.

Usage:
    python -m climsim_tpu_torch.cli.evaluate --input val_input.npy \\
        --target val_target.npy --pred my_model_pred.npy \\
        [--vset v1] [--samples samples.npy] [--out metrics.csv]
        [--out-lev levels.csv] [--device cuda]

Arrays: flat [N, nx]/[N, ny] with N a multiple of ``--ncol`` (time-major
column blocks), or [T, ncol, ny]. Targets and predictions are normalized
(scaled by ``--scale-file`` or the norm files' output scale) unless
``--raw``.

It takes the JAX CLI's flags, with these differences:

* ``--device`` (default ``cuda``) takes the place of ``--platform``:
  the metrics are computed on the card, and without one the CLI raises
  unless asked for ``--device cpu``;
* the norm files (``data/normalization.py::REF_NORM_DIR``) and ``--grid``
  (``cli/run_hybrid.py::DEFAULT_GRID``) default to their places in the
  ClimSim repository's tree relative to the working directory, where the
  JAX CLI names absolute paths.

The CSVs and the printed table are pandas frames, as JAX's; ``score``
computes their numbers without pandas.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.normalization import REF_NORM_DIR
from .run_hybrid import DEFAULT_GRID


def score(argv=None):
    """The numbers of the CLI's tables: (scoreboard dict, per-level dict
    or None without ``--out-lev``, the parsed arguments), computed on
    ``--device``."""
    from .. import variables as V
    from ..data import Normalizer
    from ..grid import Grid
    from ..metrics import level_metrics, scoreboard
    from ..ops import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--input", default=None,
                   help="flat input npy (for ps recovery); optional when "
                        "--ps is given")
    p.add_argument("--target", required=True)
    p.add_argument("--pred", required=True)
    p.add_argument("--samples", help="npy [.., ny, S] for CRPS")
    p.add_argument("--vset", default="v1")
    p.add_argument("--ncol", type=int, default=384)
    p.add_argument("--raw", action="store_true",
                   help="targets/preds already in raw units")
    p.add_argument("--scale-file", default=None,
                   help="output-scale .nc overriding the norm files' "
                        "output_scale.nc")
    p.add_argument("--ps", default=None,
                   help="npy of RAW surface pressure [N] or [T,ncol], "
                        "bypassing ps recovery from --input")
    p.add_argument("--out", default="metrics.csv")
    p.add_argument("--out-lev", default=None)
    p.add_argument("--grid", default=DEFAULT_GRID)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    vset = V.get(args.vset)
    grid = Grid.from_file(args.grid, device=dev)

    def load(path, ny):
        a = np.load(path)
        if a.ndim == 2:
            T = a.shape[0] // args.ncol
            a = a[:T * args.ncol].reshape(T, args.ncol, ny)
        return a

    if not args.input and not args.ps:
        p.error("one of --input / --ps is required")
    x = load(args.input, vset.input_feature_len) if args.input else None
    t = load(args.target, vset.target_feature_len)
    pr = load(args.pred, vset.target_feature_len)

    nz = Normalizer.from_files(
        vset, f"{REF_NORM_DIR}/inputs/input_mean.nc",
        f"{REF_NORM_DIR}/inputs/input_max.nc",
        f"{REF_NORM_DIR}/inputs/input_min.nc",
        args.scale_file or f"{REF_NORM_DIR}/outputs/output_scale.nc")
    if args.ps:
        ps = np.load(args.ps)
        if ps.ndim == 1:
            ps = ps.reshape(-1, args.ncol)
    else:
        ps = np.asarray(x[..., vset.ps_index])
        # normalized inputs -> raw ps (the reference's set_pressure_grid)
        if abs(ps.mean()) < 1e3:
            ps = ps * float(nz.div[vset.ps_index]) \
                + float(nz.mean[vset.ps_index])

    on = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    scale = None if args.raw else nz.scale.to(dev)
    samples = None
    if args.samples:
        s = np.load(args.samples)
        if s.ndim == 3:
            T = s.shape[0] // args.ncol
            s = s[:T * args.ncol].reshape(T, args.ncol, *s.shape[1:])
        samples = on(s)
    board = scoreboard(on(pr), on(t), on(ps), vset, grid, scale=scale,
                       samplepreds=samples)
    levels = level_metrics(on(pr), on(t), on(ps), vset, grid,
                           scale=scale) if args.out_lev else None
    return board, levels, args


def main(argv=None):
    import pandas as pd
    board, levels, args = score(argv)
    df = pd.DataFrame(board).T
    df.to_csv(args.out)
    print(df.round(4).to_string())
    if levels is not None:
        pd.DataFrame(levels).to_csv(args.out_lev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
