"""Validation plots: R2/RMSE/bias profiles, zonal-mean bias maps and
training curves (counterpart of ``climsim_tpu/metrics/plots.py``), with
the reference's colorblind-safe line palette. matplotlib (Agg) is
imported by each function, so the package needs it only to plot; arrays
may be numpy arrays or tensors on any device.
"""
from __future__ import annotations

import numpy as np
import torch

LINECOLORS = ["#0072B2", "#E69F00", "#882255", "#009E73", "#D55E00"]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def profile_plot(metrics_by_model: dict[str, np.ndarray], pressure=None,
                 metric_name: str = "R2", var_name: str = "",
                 save_path: str | None = None):
    """Vertical-profile plot: metric [nlev] per model, pressure on y
    (inverted, hPa)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 6))
    nlev = len(next(iter(metrics_by_model.values())))
    y = _np(pressure) / 100.0 if pressure is not None \
        else np.arange(nlev)
    for i, (name, prof) in enumerate(metrics_by_model.items()):
        ax.plot(_np(prof), y, label=name,
                color=LINECOLORS[i % len(LINECOLORS)])
    if pressure is not None:
        ax.invert_yaxis()
        ax.set_ylabel("pressure [hPa]")
    else:
        ax.set_ylabel("level")
    ax.set_xlabel(metric_name)
    ax.set_title(f"{metric_name} {var_name}".strip())
    if metric_name == "R2":
        ax.set_xlim(0, 1)
    ax.legend(fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def zonal_mean_bias(pred, target, lat, nbands: int = 16,
                    save_path: str | None = None, var_name: str = ""):
    """Zonal-mean bias map: lat band x level, like the wrapper validation
    harness plots (save_wrapper_mem_prevtend_ftorch.py:430-760).

    pred/target [T, ncol, nlev], lat [ncol]."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred, target, lat = map(_np, (pred, target, lat))
    bias = (pred - target).mean(axis=0)            # [ncol, nlev]
    order = np.argsort(lat)
    ncol = len(lat)
    band = ncol // nbands
    rows = []
    lats = []
    for b in range(nbands):
        idx = order[b * band:(b + 1) * band]
        rows.append(bias[idx].mean(axis=0))
        lats.append(lat[idx].mean())
    zb = np.stack(rows)                            # [nbands, nlev]

    fig, ax = plt.subplots(figsize=(6, 4))
    vmax = np.abs(zb).max() or 1.0
    im = ax.pcolormesh(np.asarray(lats), np.arange(zb.shape[1]), zb.T,
                       cmap="RdBu_r", vmin=-vmax, vmax=vmax,
                       shading="nearest")
    ax.invert_yaxis()
    ax.set_xlabel("latitude")
    ax.set_ylabel("level")
    ax.set_title(f"zonal-mean bias {var_name}".strip())
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def training_curves(history: list[dict], keys=("train_loss", "val_loss"),
                    save_path: str | None = None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3.2))
    for i, k in enumerate(keys):
        ys = [h[k] for h in history if k in h]
        if ys:
            ax.plot(ys, label=k, color=LINECOLORS[i % len(LINECOLORS)])
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig
