"""Dataset statistics: per-level histograms + moments per variable
(counterpart of ``climsim_tpu/data/statistics.py``).

Equivalent of the reference's dataset_statistics/ generator
(tendency_vvvv_llll.py + process_all_tendency.sh, which writes per-level
histogram/moment txt files for every input/output variable): one
vectorized pass computing min/max/mean/std/percentiles and fixed-bin
histograms per (variable, level).

Host numpy in float64, as JAX's computes them: ``torch.quantile`` refuses
inputs of more than 2**24 elements, and ``torch.histc`` bins the edge
values otherwise than ``np.histogram``.
"""
from __future__ import annotations

import json

import numpy as np

from .. import variables as V

PCTS = (0.1, 1.0, 50.0, 99.0, 99.9)


def level_statistics(x: np.ndarray, nbins: int = 100) -> dict:
    """Stats for one variable's samples [N, nlev] (or [N] scalar).

    Returns {'mean','std','min','max','pct','hist','bin_edges'}, per level.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    out = {
        "mean": x.mean(0), "std": x.std(0), "min": x.min(0),
        "max": x.max(0),
        "pct": {str(p): np.percentile(x, p, axis=0) for p in PCTS},
    }
    lo, hi = x.min(), x.max()
    if lo == hi:
        hi = lo + 1.0
    edges = np.linspace(lo, hi, nbins + 1)
    out["bin_edges"] = edges
    out["hist"] = np.stack([np.histogram(x[:, l], bins=edges)[0]
                            for l in range(x.shape[1])])
    return out


def dataset_statistics(flat: np.ndarray, vset_name: str,
                       which: str = "inputs", nbins: int = 100) -> dict:
    """Per-variable stats over a flat [N, nx|ny] array in registry order."""
    vs = V.get(vset_name)
    layout = vs.inputs if which == "inputs" else vs.outputs
    out = {}
    for name in layout.names:
        sl = layout.slices[name]
        out[name] = level_statistics(flat[:, sl], nbins)
    return out


def save_statistics(stats: dict, path: str):
    """JSON export (arrays as lists)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            return v.tolist()
        return v
    with open(path, "w") as f:
        json.dump(conv(stats), f)
