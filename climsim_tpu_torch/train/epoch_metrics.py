"""Per-epoch monitored metrics for rollout training (counterpart of
``climsim_tpu/train/epoch_metrics.py``).

The scoreboard the reference logs every epoch (rnn/utils.py:1413-1766),
with the reference metric names, over collected validation outputs:

* per-variable R2 (TSS convention) and the correlation-based
  R2netsw/R2flwds/R2precc;
* clear-sky radiation skill via Lin's concordance correlation on columns
  whose updated vertically-integrated cloud water stays < 1e-6;
* top-of-atmosphere heating skill R2_heating_top over levels 1:10 and its
  clear-sky bias;
* extreme-tendency fidelity: count ratios above the true 99.9th
  percentile and std ratios;
* the per-level correlation R2 profile;
* absolute batch-mean biases per channel;
* water/energy conservation residuals, cloud-water-path error, and
  positivity diagnostics.

Inputs are tensors (or arrays) on any device. The statistics are computed
on host copies with numpy, in the JAX package's arithmetic, and the
conservation residuals with the port's ``physics/conservation.py`` on the
tensors' device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..physics import conservation
from ..constants import DT_STEP


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _dev(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


def _rms(x: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean(torch.square(x))))

LEV_NAMES = ("dT", "dqv", "dqliq", "dqice", "du", "dv")
SFC_NAMES = ("NETSW", "FLWDS", "PRECSC", "PRECC", "SOLS", "SOLL",
             "SOLSD", "SOLLD")


def _ccc(t, p, w=None):
    """Lin's concordance correlation coefficient (rnn/utils.py:296-311),
    optionally weighted (for clear-sky masks without boolean gather)."""
    t = np.asarray(t, np.float64).ravel()
    p = np.asarray(p, np.float64).ravel()
    if w is None:
        w = np.ones_like(t)
    else:
        w = np.asarray(w, np.float64).ravel()
    n = w.sum()
    if n < 2:
        return 0.0
    mt, mp = (w * t).sum() / n, (w * p).sum() / n
    vt = (w * (t - mt) ** 2).sum() / n
    vp = (w * (p - mp) ** 2).sum() / n
    cov = (w * (t - mt) * (p - mp)).sum() / n
    denom = vt + vp + (mt - mp) ** 2
    if denom <= 0.0:
        return 0.0
    return float(cov * 2.0 / denom)


def _corr2(a, b):
    """Squared Pearson correlation, NaN -> 0 (reference's np.corrcoef**2
    with its NaN guard)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if a.size < 2 or a.std() == 0.0 or b.std() == 0.0:
        return 0.0
    r = np.corrcoef(a, b)[0, 1]
    return 0.0 if np.isnan(r) else float(r * r)


def _count_ratio_99p(pred, true):
    """Fraction of predictions above the TRUE 99.9th percentile relative
    to the truth's count (rnn/utils.py:1546-1548)."""
    pred = np.asarray(pred).ravel()
    true = np.asarray(true).ravel()
    pp = np.percentile(true, 99.9)
    n_true = (true > pp).sum()
    if n_true == 0:
        return 1.0
    return float((pred > pp).sum() / n_true)


def epoch_metrics(pred_lev, pred_sfc, true_lev, true_sfc, sp, hyai, hybi,
                  x_denorm=None, ens_pred_lev=None) -> dict:
    """Compute the monitored scoreboard.

    pred/true_lev: [N, L, ny] raw-unit tendencies, pred/true_sfc [N, ns],
    sp [N] raw surface pressure. Optional x_denorm [N, L, >=4] raw state
    (v4 channel order: T at 0, qliq at 2, qice at 3, qv last) for
    positivity and clear-sky diagnostics; ens_pred_lev [M, N, L, ny] the
    members' predictions, for the spread-skill ratio (``spread_skill``)
    and the squared correlation of two members' qv errors
    (``q_err_corr``).
    Returns {name: float | list}.
    """
    out: dict = {}
    P = _host(pred_lev)
    T = _host(true_lev)
    Ps = _host(pred_sfc)
    Ts = _host(true_sfc)
    ny = P.shape[-1]
    ns = Ps.shape[-1]

    # per-variable R2 (TSS convention of data_utils.calc_R2 collapsed to
    # the sample axis)
    for j in range(min(ny, len(LEV_NAMES))):
        p, t = P[..., j], T[..., j]
        sse = np.sum((p - t) ** 2)
        tss = np.sum((t - t.mean()) ** 2)
        out[f"R2_{LEV_NAMES[j]}"] = float(1.0 - sse / max(tss, 1e-300))
    for j in range(min(ns, len(SFC_NAMES))):
        p, t = Ps[:, j], Ts[:, j]
        sse = np.sum((p - t) ** 2)
        tss = np.sum((t - t.mean()) ** 2)
        out[f"R2_{SFC_NAMES[j]}"] = float(1.0 - sse / max(tss, 1e-300))

    # correlation-based radiation/precip skill (reference names)
    if ns >= 4:
        out["R2netsw"] = _corr2(Ts[:, 0], Ps[:, 0])
        out["R2flwds"] = _corr2(Ts[:, 1], Ps[:, 1])
        out["R2precc"] = _corr2(Ts[:, 3], Ps[:, 3])
        if ns > 4:
            out["R2swsfc"] = _corr2(Ts[:, 4:], Ps[:, 4:])

    # TOA heating skill over levels 1:10 (rnn/utils.py:1534)
    out["R2_heating_top"] = _corr2(T[:, 1:10, 0], P[:, 1:10, 0])

    # per-level correlation R2 profile [L, ny] (corrcoeff_pairs)
    mt = T.mean(axis=0, keepdims=True)
    mp = P.mean(axis=0, keepdims=True)
    cov = ((T - mt) * (P - mp)).mean(axis=0)
    denom = T.std(axis=0) * P.std(axis=0)
    r2_lev = np.where(denom > 0, cov / np.maximum(denom, 1e-300), 0.0) ** 2
    out["r2_lev"] = r2_lev.tolist()
    out["r2_lev_mean"] = float(r2_lev.mean())

    # absolute batch-mean biases per channel (compute_absolute_biases)
    bias_ch = np.abs((P - T).mean(axis=0)).mean(axis=0)   # [ny]
    out["bias_lev"] = float(bias_ch.mean())
    out["bias_heating"] = float(bias_ch[0])
    if ny >= 4:
        out["bias_clw"] = float(bias_ch[2])
        out["bias_cli"] = float(bias_ch[3])
    out["bias_sfc"] = float(np.abs((Ps - Ts).mean(axis=0)).mean())

    # extreme-tendency fidelity (count ratios over the true 99.9p; std
    # ratios, rnn/utils.py:1539-1560)
    if ns >= 4:
        out["prec_99p_ratio"] = _count_ratio_99p(Ps[:, 3], Ts[:, 3])
        ts_std = Ts[:, 3].std()
        out["prec_std_frac"] = float(Ps[:, 3].std() / max(ts_std, 1e-300))
    ratios = [_count_ratio_99p(P[..., j], T[..., j]) for j in range(ny)]
    out["tend_99p_ratio"] = float(np.mean(ratios))
    if ny >= 4:
        stds = [P[..., j].std() / max(T[..., j].std(), 1e-300)
                for j in range(1, ny - 2)]
        out["hum_std_ratio"] = float(np.mean(stds))

    # conservation residuals (rnn/metrics.py definitions)
    if ny >= 4 and ns >= 4:
        pl, ps_, tl, ts_, sp_ = (_dev(a) for a in (pred_lev, pred_sfc,
                                                   true_lev, true_sfc, sp))
        hy = tuple(_dev(h).to(device=pl.device, dtype=pl.dtype)
                   for h in (hyai, hybi))
        e = conservation.energy_residual(pl, ps_, sp_, *hy)
        et = conservation.energy_residual(tl, ts_, sp_, *hy)
        out["h_conservation"] = _rms(e - et)
        w = conservation.water_residual(pl, ps_, sp_, *hy)
        out["water_conservation"] = _rms(w)
        cwp_p = conservation.cloud_water_path(pl, sp_, *hy)
        cwp_t = conservation.cloud_water_path(tl, sp_, *hy)
        out["cldpath_err"] = _rms(cwp_p - cwp_t)

    # positivity + clear-sky diagnostics need the raw input state
    if x_denorm is not None and ny >= 4:
        X = _host(x_denorm)
        qv_new = X[..., -1] + DT_STEP * P[..., 1]
        out["neg_qv_frac"] = float((qv_new < 0).mean())
        qn_before = X[..., 2] + X[..., 3]
        qn_new = qn_before + DT_STEP * (P[..., 2] + P[..., 3])
        out["neg_qn_frac"] = float((qn_new < 0).mean())

        # clear-sky mask: updated column cloud water < 1e-6 using the TRUE
        # tendencies (rnn/utils.py:1513-1518)
        qn_new_true_vint = (qn_before
                            + DT_STEP * (T[..., 2] + T[..., 3])).sum(axis=1)
        mask = (qn_new_true_vint < 1e-6).astype(np.float64)
        if ns >= 2:
            out["R2netsw_clearsky"] = _ccc(Ts[:, 0], Ps[:, 0], mask) ** 2
            out["R2flwds_clearsky"] = _ccc(Ts[:, 1], Ps[:, 1], mask) ** 2
        nmask = mask.sum()
        if nmask >= 2:
            out["bias_heating_top"] = float(
                ((T[:, 1:10, 0] - P[:, 1:10, 0])
                 * mask[:, None]).sum() / (nmask * 9))
        else:
            out["bias_heating_top"] = 0.0

    if ns >= 4:
        out["neg_precip_frac"] = float((Ps[:, 3] < 0).mean())

    if ens_pred_lev is not None:
        from .probabilistic import spread_skill_ratio
        E = _dev(ens_pred_lev)
        Tt = torch.as_tensor(T, dtype=E.dtype, device=E.device)
        out["spread_skill"] = float(spread_skill_ratio(
            E.reshape(E.shape[0], -1), Tt.reshape(-1)))
        # squared correlation of two members' error fields
        if E.shape[0] >= 2 and ny >= 2:
            En = _host(E)
            out["q_err_corr"] = _corr2(En[0][..., 1] - T[..., 1],
                                       En[1][..., 1] - T[..., 1])
    return out
