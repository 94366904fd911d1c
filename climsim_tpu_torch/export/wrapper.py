"""Online inference wrapper: the raw-units emulator step for host coupling
(counterpart of ``climsim_tpu/export/wrapper.py``).

Replaces the reference's TorchScript + FTorch export path
(rnn/save_wrapper_mem_prevtend_ftorch.py:185-427). Contract (SURVEY.md
§7.4 item 5, online_testing/README.md §3.1): forward takes UN-normalized
state and returns UN-normalized tendencies,
    (x_main [B, 60, nx_raw], x_sfc [B, nx_sfc], mem)
        -> (out_lev [B, 60, 6], out_sfc [B, 8], mem)
with preprocessing inlined: SNOWHICE>=1e10 -> -1 fix, exponential cloud
transform (v4) or qn+liq_frac conversion (v5), mean/div normalization, RH
clipping, NaN/Inf scrubbing (:199-249); postprocessing is the
mp-constraint split + NaN scrub (:285-329,382-387).

``OnlineWrapper`` is an ``nn.Module`` that holds the model (with its
weights) as a submodule and the normalizer's six arrays and the three
exp-transform coefficients as buffers, so ``torch.export`` bakes all of
them into the artifact (``export/serialize.py``), as ``jax.export``
bakes the JAX wrapper's ``params``. It takes ``(model, norm, lbd_qc,
lbd_qi, lbd_qn, cfg)`` where the JAX wrapper takes ``(model, params,
...)``: a torch model carries its weights. The wrapper is batch-major,
as JAX's is, so a ``level_major`` model raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..models.rnn import postprocess_mp, temperature_scaling
from ..physics import transforms

__all__ = ["WrapperConfig", "OnlineWrapper", "flat_output"]

_NORM = ("mean_lev", "div_lev", "mean_sfc", "div_sfc", "scale_lev",
         "scale_sfc")


@dataclass(frozen=True)
class WrapperConfig:
    v5_input: bool = False
    mp_mode: int = 1
    snowhice_fix: bool = True
    snowhice_index: int = 15      # SNOWHICE position in x_sfc (v4 sfc order)
    qinput_prune: bool = False
    qinput_prune_lev: int = 15
    rh_prune: bool = True
    # normalized-input clipping of the online trainers
    # (climsim_datapip.py:11-160): dyn forcings to +-clip_dyn, previous
    # physics tendencies to +-clip_phy; channel ranges in the level layout
    clip_dyn: float | None = None
    dyn_slice: tuple = (6, 12)
    clip_phy: float | None = None
    phy_slice: tuple = (12, 20)
    mp_constraint: bool = True


class OnlineWrapper(nn.Module):
    """Bundles the model and the normalization into the raw-units step."""

    def __init__(self, model: nn.Module, norm, lbd_qc, lbd_qi, lbd_qn,
                 cfg: WrapperConfig = WrapperConfig()):
        """norm: a LevelNormalizer (or anything with its six arrays) whose
        mean/div match the model's input layout; lbd_*: per-level
        exponential-transform coefficients."""
        super().__init__()
        if getattr(model, "level_major", False):
            raise ValueError("OnlineWrapper feeds batch-major [B, L, C] "
                             "inputs; a level_major model takes [L, C, B]")
        self.model = model
        self.cfg = cfg
        dev = next(model.parameters()).device
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        for name in _NORM:
            self.register_buffer(name, f32(getattr(norm, name)))
        for name, a in (("lbd_qc", lbd_qc), ("lbd_qi", lbd_qi),
                        ("lbd_qn", lbd_qn)):
            self.register_buffer(name, f32(a))

    def preprocess(self, x_main_raw, x_sfc_raw):
        cfg = self.cfg
        x_sfc = x_sfc_raw
        if cfg.snowhice_fix:
            x_sfc = torch.where(x_sfc >= 1e10, -1.0, x_sfc)
        x_main = x_main_raw.clone()
        if cfg.v5_input:
            qn = x_main_raw[:, :, 2] + x_main_raw[:, :, 3]
            if cfg.qinput_prune:
                qn[:, :cfg.qinput_prune_lev] = 0.0
            x_main[:, :, 2] = transforms.cloud_exp_transform(qn, self.lbd_qn)
            x_main[:, :, 3] = temperature_scaling(x_main_raw[:, :, 0])
        else:
            x_main[:, :, 2] = transforms.cloud_exp_transform(
                x_main_raw[:, :, 2], self.lbd_qc)
            x_main[:, :, 3] = transforms.cloud_exp_transform(
                x_main_raw[:, :, 3], self.lbd_qi)
        x_main = (x_main - self.mean_lev) / self.div_lev
        x_sfc = (x_sfc - self.mean_sfc) / self.div_sfc
        if (not cfg.v5_input) and cfg.qinput_prune:
            x_main[:, :cfg.qinput_prune_lev, 2] = 0.0
        if cfg.rh_prune:
            x_main[:, :, 1] = torch.clamp(x_main[:, :, 1], 0.0, 1.2)
        for clip, (a, b) in ((cfg.clip_dyn, cfg.dyn_slice),
                             (cfg.clip_phy, cfg.phy_slice)):
            if clip is not None:
                x_main[:, :, a:b] = torch.clamp(x_main[:, :, a:b], -clip,
                                                clip)
        x_main = torch.where(torch.isfinite(x_main), x_main, 0.0)
        return x_main, x_sfc

    def forward(self, x_main_raw, x_sfc_raw, mem, eps_prev=None,
                noise=None):
        """Raw-units step. A stochastic model with ``ar_noise_rho > 0``
        takes the AR(1) signature ``(x, xs, mem, eps_prev, noise) -> (out,
        out_sfc, mem, eps)``, threading the noise across coupled steps;
        ``noise`` stands for the JAX wrapper's ``noise_key``: a
        ``torch.Generator`` on the model's device, or the standard-normal
        draw [Le, B, nneur[-1]] itself (the form an exported step takes).
        Without ``eps_prev`` the step is deterministic, as in JAX."""
        x_main, x_sfc = self.preprocess(x_main_raw, x_sfc_raw)
        eps_out = None
        if eps_prev is not None:
            if not (getattr(self.model, "add_stochastic_layer", False)
                    and self.model.ar_noise_rho > 0.0):
                raise ValueError("eps_prev takes a stochastic model with "
                                 "ar_noise_rho > 0")
            out, out_sfc, mem, eps_out = self.model(
                x_main, x_sfc, mem, deterministic=False, eps_prev=eps_prev,
                noise=noise)
        else:
            # AR-noise models return a 4-tuple even deterministically
            out, out_sfc, mem = self.model(x_main, x_sfc, mem)[:3]
        if self.cfg.mp_constraint:
            out, out_sfc = postprocess_mp(
                out, out_sfc, x_main_raw, self.scale_lev[None],
                self.scale_sfc, mp_mode=self.cfg.mp_mode)
        else:
            out = out / self.scale_lev
            out_sfc = out_sfc / self.scale_sfc
        out = torch.where(torch.isfinite(out), out, 0.0)
        out_sfc = torch.where(torch.isfinite(out_sfc), out_sfc, 0.0)
        if eps_out is not None:
            return out, out_sfc, mem, eps_out
        return out, out_sfc, mem


def flat_output(out_lev, out_sfc):
    """Flatten (out_lev [B, 60, 6], out_sfc [B, 8]) into the binding
    368-feature layout [ptend_t, ptend_q0001, ptend_q0002, ptend_q0003,
    ptend_u, ptend_v (60 each), NETSW, FLWDS, PRECSC, PRECC, SOLS, SOLL,
    SOLSD, SOLLD] (online_testing/README.md §3.1)."""
    B = out_lev.shape[0]
    lev = out_lev.transpose(1, 2).reshape(B, -1)
    return torch.cat([lev, out_sfc], dim=1)
