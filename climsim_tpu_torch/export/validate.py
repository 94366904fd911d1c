"""Export-equivalence validation harness: offline rollout of the wrapped
model over held-out data before shipping (counterpart of
``climsim_tpu/export/validate.py``).

Equivalent of the reference's single-column offline validation inside
every wrapper script (rnn/save_wrapper_mem_prevtend_ftorch.py:430-760):
re-run the raw-units wrapper autoregressively over a held-out period,
compare against truth, and emit distribution/zonal-bias summaries (plots
via metrics.plots) plus pass/fail gates on NaNs and gross drift.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["offline_rollout", "validate_export",
           "ensemble_error_correlation"]


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def offline_rollout(wrapper_step, x_main_raw_series, x_sfc_raw_series,
                    mem0, teacher_forced: bool = True):
    """Run the wrapper over a [T, B, ...] raw series, step by step.

    teacher_forced=True feeds the TRUE state each step (offline
    validation, memory still threads). False would need a host state
    advance, which this function does not do: it raises
    ``NotImplementedError`` (use climsim_tpu_torch.online.HybridLoop).
    Returns (out_lev [T,B,L,ny], out_sfc [T,B,ns], final_mem).
    """
    if not teacher_forced:
        raise NotImplementedError(
            "offline_rollout runs teacher-forced only; a free-running "
            "rollout advances the state on the host: use "
            "climsim_tpu_torch.online.HybridLoop")
    mem, outs, out_sfcs = mem0, [], []
    with torch.no_grad():
        for xm, xs in zip(x_main_raw_series, x_sfc_raw_series):
            out, out_sfc, mem = wrapper_step(xm, xs, mem)
            outs.append(out)
            out_sfcs.append(out_sfc)
    return torch.stack(outs), torch.stack(out_sfcs), mem


def validate_export(wrapper_step, x_main_raw_series, x_sfc_raw_series,
                    y_true_lev, y_true_sfc, mem0, lat=None,
                    plot_dir: str | None = None) -> dict:
    """Full validation report: NaN gate, per-channel bias/rmse, optional
    zonal-bias plots. Returns a summary dict with 'passed'."""
    outs, out_sfcs, _ = offline_rollout(wrapper_step, x_main_raw_series,
                                        x_sfc_raw_series, mem0)
    outs, out_sfcs = _np(outs), _np(out_sfcs)
    yt, yts = _np(y_true_lev), _np(y_true_sfc)

    report: dict = {"nan_frac": float(np.mean(~np.isfinite(outs)))}
    err = outs - yt
    report["lev_bias"] = err.mean(axis=(0, 1, 2)).tolist()
    report["lev_rmse"] = np.sqrt((err ** 2).mean(axis=(0, 1, 2))).tolist()
    errs = out_sfcs - yts
    report["sfc_bias"] = errs.mean(axis=(0, 1)).tolist()
    report["sfc_rmse"] = np.sqrt((errs ** 2).mean(axis=(0, 1))).tolist()
    # error-vs-magnitude ratio: flags a broken export even when the model
    # is imperfect
    scale = np.sqrt((yt ** 2).mean(axis=(0, 1, 2))) + 1e-30
    report["rel_rmse"] = (np.asarray(report["lev_rmse"]) / scale).tolist()
    report["passed"] = bool(report["nan_frac"] == 0.0
                            and np.isfinite(outs).all())

    if plot_dir and lat is not None:
        import os
        from ..metrics.plots import zonal_mean_bias
        os.makedirs(plot_dir, exist_ok=True)
        for ch in range(min(outs.shape[-1], 4)):
            zonal_mean_bias(outs[..., ch], yt[..., ch], _np(lat),
                            save_path=os.path.join(plot_dir,
                                                   f"zonal_bias_ch{ch}.png"),
                            var_name=f"channel {ch}")
        report["plots"] = plot_dir
    return report


def ensemble_error_correlation(ens_pred: torch.Tensor,
                               truth: torch.Tensor) -> torch.Tensor:
    """Mean pairwise Pearson correlation of member ERROR fields
    (the ensemble-error-correlation analysis of the reference's wrapper
    validation harness, rnn/save_wrapper_mem_prevtend_ftorch.py:430-760).

    ens_pred [M, ...], truth [...]. ~0 = members make independent errors
    (ideal spread); ~1 = shared systematic error (ensemble adds nothing).
    """
    M = ens_pred.shape[0]
    err = (ens_pred - truth[None]).reshape(M, -1)
    err = err - err.mean(dim=1, keepdim=True)
    norm = torch.linalg.norm(err, dim=1)
    C = (err @ err.T) / torch.clamp(norm[:, None] * norm[None, :],
                                    min=1e-30)
    return (C.sum() - torch.trace(C)) / (M * (M - 1))
