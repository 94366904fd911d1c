"""Per-variable and per-level metric tables, the scoreboard of the
ClimSim evaluation (counterpart of ``climsim_tpu/metrics/report.py``):
weighted per-variable MAE/RMSE/R2/bias (and CRPS for sampled
predictions), averaged over the grid and, for level variables, over the
levels.

``scoreboard`` and ``level_metrics`` compute the numbers on the
tensors' device and return plain dicts; ``evaluate`` and
``per_level_table`` put them in pandas frames, as the JAX package
returns them. pandas is imported by those two alone, so the numbers need
no pandas; where it is absent they raise ImportError.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import variables as V
from ..grid import Grid
from . import metrics as M
from . import weighting


def _weighted(pred, target, ps_raw, vset, grid, scale):
    t = lambda a: torch.as_tensor(a)
    wp = weighting.weight_outputs(t(pred), ps_raw, vset, grid, scale)
    wt = weighting.weight_outputs(t(target), ps_raw, vset, grid, scale)
    return (weighting.split_variables(wp, vset),
            weighting.split_variables(wt, vset))


def scoreboard(pred, target, ps_raw, vset: V.VariableSet, grid: Grid,
               scale=None, samplepreds=None) -> dict[str, dict[str, float]]:
    """The full weighted evaluation: {output variable: {"MAE", "RMSE",
    "R2", "bias"[, "CRPS"]}} in W/m^2 for the energy-convertible
    variables.

    pred/target [T, ncol, ny] (scaled if ``scale`` [ny] is given, else
    raw), ps_raw [T, ncol] raw surface pressure, samplepreds optional
    [T, ncol, ny, S] for CRPS."""
    pv, tv = _weighted(pred, target, ps_raw, vset, grid, scale)
    rows = {}
    for name in vset.outputs.names:
        p, t = pv[name], tv[name]
        rows[name] = {k: float(torch.mean(fn(p, t)))
                      for k, fn in M.METRIC_FNS.items()}
    if samplepreds is not None:
        # the weighting chain is linear, so it is applied per sample
        # before the CRPS estimator
        samplepreds = torch.as_tensor(samplepreds)
        wsp = torch.stack([
            weighting.weight_outputs(samplepreds[..., s], ps_raw, vset, grid,
                                     scale)
            for s in range(samplepreds.shape[-1])], dim=-1)
        for name in vset.outputs.names:
            sl = vset.outputs.slices[name]
            sp = wsp[..., sl, :]
            if sl.stop - sl.start == 1:
                sp = sp[..., 0, :]
            rows[name]["CRPS"] = float(torch.mean(M.crps(sp, tv[name])))
    return rows


def level_metrics(pred, target, ps_raw, vset: V.VariableSet, grid: Grid,
                  scale=None) -> dict[tuple[str, str], np.ndarray]:
    """Level-resolved metrics of the level variables: {(variable,
    metric): [nlev] array}."""
    pv, tv = _weighted(pred, target, ps_raw, vset, grid, scale)
    return {(name, k): fn(pv[name], tv[name]).cpu().numpy()
            for name in vset.outputs.lev_names
            for k, fn in M.METRIC_FNS.items()}


def evaluate(pred, target, ps_raw, vset: V.VariableSet, grid: Grid,
             scale=None, samplepreds=None):
    """``scoreboard`` as a pandas DataFrame indexed by output variable."""
    import pandas as pd
    return pd.DataFrame(scoreboard(pred, target, ps_raw, vset, grid, scale,
                                   samplepreds)).T


def per_level_table(pred, target, ps_raw, vset: V.VariableSet, grid: Grid,
                    scale=None):
    """``level_metrics`` as a pandas DataFrame, a (variable, metric)
    column each, a row a level."""
    import pandas as pd
    return pd.DataFrame(level_metrics(pred, target, ps_raw, vset, grid,
                                      scale))

