"""Autoregressive rollout training of the memory-RNN emulator (counterpart
of ``climsim_tpu/train/rollout.py``).

* time-contiguous chunks are split into rollout windows of W coupled
  steps; each window is one update: a Python loop over the W steps
  carrying the latent memory, with BPTT through the loop;
* the memory is detached between windows;
* replay modes 'full'/'mixed' substitute the model's previous predictions
  into the previous-physics input channels ('mixed' for a random column
  subset whose fraction ramps with ``gradual_mixing_end_epoch``);
* the loss = weighted huber/mse/mae + energy, water, cloud-water-path,
  precipitation, GEL-precipitation and bias terms, and with the raw state
  the negative-precipitation, positivity and RH-consistency terms;
* the curriculum ``rollout_schedule`` maps epoch -> W;
* ``remat`` checkpoints each window step (activations are recomputed in
  the backward pass);
* semi-online training (``semi_online``, rnn/utils.py:994-1060): the
  prognostic input channels are rebuilt from the model's own previous
  prediction plus the dynamics increment of the true series,
  X_pred[k] = X_pred[k-1] + dt y_pred[k-1] + dX_dyn[k] with
  dX_dyn[k] = (X_true[k] - X_true[k-1]) - dt y_true[k-1], then
  normalized (the cloud-exp transform with ``lbd_qc``/``lbd_qi``, the
  state normalizer ``xmean_prog``/``xdiv_prog``); windows carry
  'x_lev_raw' and 'y_lev_raw' [W, B, L, >= n_prog];
* with ``pass_x_raw`` the raw level state rides along to ``apply_fn``
  (the physics-constrained model reads it: ``phys_apply``,
  ``phys_mem_shape``), and with ``pass_y_true`` the true tendencies do in
  training updates;
* with ``ensemble_size`` M > 1 each member runs the model from its own
  memory [M, B, L, nm] and its own noise, and the window trains on a
  CRPS-family loss over the members (``ens_loss``; before
  ``crps_start_epoch`` the deterministic loss of the member mean), plus
  ``w_det`` times the member mean's squared error; the M members go
  through the model as one batch of M x B columns (the model is
  column-wise, so this computes what JAX's vmap over members computes),
  and with ``ar_noise_rho > 0`` the AR(1) noise is carried through the
  window;
* the optimizers are optax's adam and adamw (as torch's Adam and AdamW),
  and the JAX package's soap, muon and schedule-free AdamW
  (``train/soap.py``, ``train/muon.py``, ``train/schedule_free.py``).

The model's parameters and the optimizer are state of the trainer and are
updated in place; ``run_epoch`` and ``run_epoch_fused`` (the epoch the
training CLI runs; with a mesh, data-parallel over its ranks) return the
carried memory and a record, and
``save_rollout_checkpoint``/``restore_rollout_checkpoint`` keep the best
epochs by validation loss.

The ensemble's noise comes from the trainer's ``noise_source(step,
member, shape)``: by default ``KeyedNoise``, a generator keyed by
(``cfg.seed``, the step's index in the window, the member), as JAX keys
its draws by ``fold_in(PRNGKey(seed), step)`` split M ways, so that every
window draws the same noise, as in JAX. Nothing is drawn from the global
RNG.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch.utils.checkpoint import checkpoint

from ..constants import DT_STEP
from ..ops import resolve_device
from ..parallel.mesh import all_reduce_mean_, axis_rank
from ..physics import conservation
from . import losses as L
from . import probabilistic as P
from .muon import Muon
from .schedule_free import ScheduleFreeAdamW
from .schedules import one_cycle, step_decay, warmup_constant
from .soap import SOAP


@dataclass
class RolloutConfig:
    # rollout curriculum: epoch thresholds -> window length, e.g.
    # {0: 1, 2: 2, 4: 3, 8: 5}
    rollout_schedule: dict = field(default_factory=lambda: {0: 1, 2: 2, 4: 3})
    loss: str = "huber"
    lr: float = 1e-3
    optimizer: str = "adam"
    weight_decay: float = 0.0
    # loss term weights
    w_main: float = 1.0
    w_energy: float = 0.0
    w_water: float = 0.0
    w_precip: float = 0.0
    # GEL loss on window-accumulated precipitation
    w_gel_precip: float = 0.0
    gel_lambda: float = 1.0
    # absolute batch-mean bias penalty over the window outputs
    w_bias: float = 0.0
    # raw-state terms (need pass_x_raw): RH consistency, qv and qn
    # positivity after one DT_STEP; mp_mode 1/-1 reads dqn from output 2,
    # otherwise outputs 2 + 3
    w_rh: float = 0.0
    rh_max: float = 1.05
    w_qvpos: float = 0.0
    w_qnpos: float = 0.0
    mp_mode: int = 1
    # cloud-water-path MSE between predicted and true tendencies
    w_cld: float = 0.0
    # the physics model's negative-precipitation penalty (its aux
    # 'prec_negative')
    w_precip_neg: float = 0.0
    # ensemble training: w_det x the squared error of the member mean over
    # the level and surface outputs
    w_det: float = 0.0
    # static loss-weight factors: heating tendencies in the top
    # strat_weight_levels levels x strat_temp_weight_factor; all surface
    # scalars x scalar_weight_factor
    strat_temp_weight_factor: float = 1.0
    scalar_weight_factor: float = 1.0
    strat_weight_levels: int = 10
    # LR schedule: None | 'onecycle' | 'step' | 'warmup'
    lr_schedule: str | None = None
    schedule_steps: int = 10000       # total steps (onecycle)
    lr_gamma: float = 0.95            # step-decay factor
    decay_every: int = 1000           # step-decay interval (steps)
    warmup_steps: int = 200
    # OneCycle knobs: peak lr (None -> lr is the peak), floor lr (None ->
    # peak/div/1e4), warmup fraction, anneal shape
    scheduler_max_lr: float | None = None
    scheduler_min_lr: float | None = None
    scheduler_pct_start: float = 0.3
    scheduler_annealing: str = "cos"
    # replay: None | 'full' | 'mixed'
    replay: str | None = None
    replay_slice: tuple = (15, 20)   # input channels holding prev tendencies
    pred_slice: tuple = (0, 5)       # output channels substituted in
    gradual_mixing_end_epoch: int = 10
    # semi-online training: the first n_prog input channels rebuilt from
    # the model's previous prediction and the true dynamics increment;
    # windows carry 'x_lev_raw' and 'y_lev_raw' (raw state and raw true
    # tendencies)
    semi_online: bool = False
    # the raw level state: windows carry 'x_lev_raw' [W, B, L, C], passed
    # to apply_fn as x_raw (the physics model reads it)
    pass_x_raw: bool = False
    # the true normalized tendencies go to the model as y_true in training
    # updates (teacher-forced radiation state); apply_fn takes a 6th
    # argument
    pass_y_true: bool = False
    n_prog: int = 6
    # stochastic/ensemble training: ensemble_size members, each with its
    # own memory and noise, trained on ens_loss over the members: crps |
    # crps_af | crps_sorted | energy | variogram | ds; ens_sumvar sums the
    # score over each column's features; ens_beta weighs the skill term;
    # before crps_start_epoch the deterministic loss of the member mean
    ensemble_size: int = 1
    ens_loss: str = "crps"
    ens_sumvar: bool = False
    ens_beta: float = 1.0
    crps_start_epoch: int = 0
    # when the curriculum lengthens the window, scale the LR by the window
    # ratio and reset the optimizer state
    timestepped_optimizer: bool = False
    # gradient checkpointing of each window step: BPTT keeps only the
    # per-step carries and recomputes each step's insides in the backward
    remat: bool = False
    seed: int = 0

    def window_for_epoch(self, epoch: int) -> int:
        w = 1
        for e, t in sorted(self.rollout_schedule.items()):
            if epoch >= e:
                w = t
        return w

    def mix_fraction(self, epoch: int) -> float:
        if self.replay != "mixed":
            return 1.0 if self.replay == "full" else 0.0
        return min(1.0, (epoch + 1) / max(1, self.gradual_mixing_end_epoch))


def make_schedule(cfg: RolloutConfig):
    """The learning rate as a function of the update count."""
    if cfg.lr_schedule == "onecycle":
        # initial lr = cfg.lr, peak = scheduler_max_lr, final =
        # scheduler_min_lr
        peak = cfg.scheduler_max_lr or cfg.lr
        div = (peak / cfg.lr) if cfg.scheduler_max_lr else 25.0
        fdiv = (cfg.lr / cfg.scheduler_min_lr) if cfg.scheduler_min_lr \
            else 1e4
        return one_cycle(peak, cfg.schedule_steps,
                         pct_start=cfg.scheduler_pct_start, div_factor=div,
                         final_div_factor=fdiv,
                         annealing=cfg.scheduler_annealing)
    if cfg.lr_schedule == "step":
        return step_decay(cfg.lr, cfg.decay_every, cfg.lr_gamma)
    if cfg.lr_schedule == "warmup":
        return warmup_constant(cfg.lr, cfg.warmup_steps)
    if cfg.lr_schedule is not None:
        raise ValueError(cfg.lr_schedule)
    lr = cfg.lr
    return lambda step: lr


SCHEDULE_FREE = ("adamwschedulefree", "schedulefree")


def optimizer_schedule(cfg: RolloutConfig):
    """The learning rate of each update as the trainer sets it: the
    schedule, except for schedule-free AdamW, which JAX gives ``cfg.lr``
    whatever the schedule (rollout.py:195-203)."""
    if cfg.optimizer in SCHEDULE_FREE:
        lr = cfg.lr
        return lambda step: lr
    return make_schedule(cfg)


def make_optimizer(cfg: RolloutConfig, params) -> torch.optim.Optimizer:
    """optax's adam/adamw as torch optimizers, with optax's defaults (b1
    0.9, b2 0.999, eps 1e-8), or the JAX package's soap, muon and
    schedule-free AdamW with their defaults and ``cfg.weight_decay``, at
    the schedule's first learning rate."""
    sched = optimizer_schedule(cfg)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=sched(0), betas=(0.9, 0.999),
                                eps=1e-8)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=sched(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.optimizer in SCHEDULE_FREE:
        return ScheduleFreeAdamW(params, lr=cfg.lr,
                                 weight_decay=cfg.weight_decay)
    if cfg.optimizer in ("soap", "muon"):
        cls = SOAP if cfg.optimizer == "soap" else Muon
        return cls(params, lr=sched(cls.schedule_offset),
                   weight_decay=cfg.weight_decay)
    raise ValueError(cfg.optimizer)


def _ensemble_score(cfg: RolloutConfig):
    """The probabilistic loss of ``cfg.ens_loss`` as f(members [M, B,
    ...], truth [B, ...]) (rollout.py:441-467)."""
    bb = cfg.ens_beta
    flat = lambda a: a.reshape(a.shape[0], a.shape[1], -1) \
        if a.dim() > 3 else a
    fn = {"crps": lambda e, o: P.crps_kernel(e, o, beta=bb),
          "crps_af": lambda e, o: P.crps_almost_fair(e, o, beta=bb),
          "crps_sorted": lambda e, o: P.crps_sample_sorted(e, o, beta=bb),
          "energy": lambda e, o: P.energy_score(
              e.reshape(e.shape[0], -1, e.shape[-1]),
              o.reshape(-1, o.shape[-1])),
          # over each column's flattened features
          "variogram": lambda e, o: P.variogram_score(
              flat(e), o.reshape(o.shape[0], -1)),
          "ds": lambda e, o: P.dawid_sebastiani(e, o)}[cfg.ens_loss]
    if not cfg.ens_sumvar:
        return fn
    # summed over each column's features before the batch mean: the mean
    # times the feature count
    return lambda e, o: fn(e, o) * (o.numel() // o.shape[0])


class KeyedNoise:
    """The ensemble's default noise source: ``(step, member, shape) ->``
    a standard-normal float32 draw on ``device`` from a generator seeded
    by (``seed``, the step's index in the window, the member), as JAX
    keys a member's draw by ``split(fold_in(PRNGKey(seed), step),
    M)[member]``. Every window draws the same noise, as in JAX."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def __call__(self, step: int, member: int, shape) -> torch.Tensor:
        key = ((self.seed * 1_000_003 + step) * 1_000_033 + member) \
            % (1 << 63)
        g = torch.Generator(device=self.device).manual_seed(key)
        return torch.randn(shape, generator=g, device=self.device)


def phys_apply(model, x_lev, x_sfc, mem, x_raw, y_true=None):
    """``apply_fn`` for ``PhysicalRNNAutoreg``: the raw state (and, in a
    teacher-forced update, the true tendencies) go to the model, and the
    trainer reads the first three of its four outputs."""
    return model(x_lev, x_sfc, mem, x_raw, y_true)


def phys_mem_shape(model):
    """``mem_shape`` for ``PhysicalRNNAutoreg``: the latent memory on the
    CRM levels plus the stored-precipitation slot, (B, L - ilev_crm,
    nh_mem + 1), as cli/train_rollout.py:397-398 gives it."""
    return lambda B, nlev: (B, nlev - model.ilev_crm, model.nh_mem + 1)


def channel_major_apply(model, x_lev, x_sfc, mem, x_raw=None):
    """``apply_fn`` for a channel-major model (``RNNAutoreg`` with
    ``level_major=True``): the trainer's [B, L, C] inputs, memory and
    outputs are moved to and from the model's [L, C, B] at its boundary."""
    out, out_sfc, new_mem = model(x_lev.permute(1, 2, 0), x_sfc,
                                  mem.permute(1, 2, 0))
    return out.permute(2, 0, 1), out_sfc, new_mem.permute(2, 0, 1)


class GlobalBatch:
    """Reductions over the columns of every rank of ``group``, for the
    loss terms of a data-parallel window that are not means of per-column
    terms (the bias penalty's batch means, the GEL exponent's mean): the
    sums go through the differentiable ``all_reduce``, whose backward sums
    the ranks' gradients, so after the trainer averages the gradients
    each term's gradient is the global batch's. Every rank holds an equal
    block of columns."""

    def __init__(self, group):
        self.group = group

    def mean(self, a: torch.Tensor) -> torch.Tensor:
        """The mean over dim 0 of the global batch."""
        n = a.shape[0] * dist.get_world_size(self.group)
        return dist_nn.all_reduce(a.sum(dim=0), group=self.group) / n

    def nanmean(self, a: torch.Tensor) -> torch.Tensor:
        """The nanmean over dim 0 of the global batch: the NaNs of every
        rank are left out of the global count."""
        count = (~torch.isnan(a)).sum(dim=0).to(a.dtype)
        dist.all_reduce(count, group=self.group)
        return dist_nn.all_reduce(torch.nansum(a, dim=0),
                                  group=self.group) / count


class RolloutTrainer:
    """Drives window updates of an RNNAutoreg-style model.

    ``apply_fn(model, x_lev, x_sfc, mem, x_raw[, y_true]) -> (out
    [B, L, ny], out_sfc [B, ny_sfc], new_mem, ...)``; the default calls
    ``model(x_lev, x_sfc, mem)``. ``mem_shape(B, nlev)`` gives the
    per-batch memory shape, by default [B, nlev, model.nh_mem]. Data
    windows are dicts of arrays or tensors with a leading window axis W:
    x_lev [W, B, L, nx], x_sfc [W, B, ns], y_lev [W, B, L, ny], y_sfc
    [W, B, nys], sp [W, B] raw surface pressure, and with ``pass_x_raw``
    x_lev_raw [W, B, L, C] the raw level state; with ``semi_online`` also
    y_lev_raw [W, B, L, C] the raw true tendencies, and the state
    normalization of the rebuilt channels: ``xmean_prog``/``xdiv_prog``
    [L or 1, n_prog] and the cloud-exp coefficients ``lbd_qc``/``lbd_qi``
    [L] (each optional, as in JAX).

    With ``cfg.ensemble_size`` M > 1 the memory is [M, B, ...] and the
    model is called directly (as JAX's trainer applies it) as
    ``model(x, x_sfc, mem, deterministic=False, eps_prev=, noise=)`` on
    the M members folded into one batch; ``noise_source(step, member,
    shape)`` gives each member's fresh draw (default ``KeyedNoise``;
    the tests replace it to replay other draws).

    ``device=None`` means ``"cuda"`` (and raises without a CUDA device);
    the model's parameters must already live on that device.
    """

    def __init__(self, model, cfg: RolloutConfig, hyai, hybi,
                 yscale_lev=None, yscale_sca=None,
                 xmean_prog=None, xdiv_prog=None, lbd_qc=None, lbd_qi=None,
                 apply_fn=None, mem_shape=None, device=None,
                 noise_source=None):
        if cfg.ensemble_size > 1 and apply_fn is not None:
            raise ValueError("ensemble training calls the model directly "
                             "(as JAX's trainer does); it takes no apply_fn")
        self.device = resolve_device(device)
        pdev = next(model.parameters()).device
        if pdev.type != self.device.type:
            raise ValueError(f"the model's parameters are on {pdev}, the "
                             f"trainer runs on {self.device}")
        self.model = model
        self._apply = apply_fn or (
            lambda m, xl, xs, mem, xr: m(xl, xs, mem))
        # the default memory: one per level, or with separate radiation
        # the CRM's 50 bottom levels (JAX's trainer, rollout.py:250-256)
        self._mem_shape = mem_shape or (
            lambda B, nlev: (B, 50 if getattr(model, "separate_radiation",
                                              False) else nlev,
                             getattr(model, "nh_mem", 16)))
        self.cfg = cfg
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                      device=self.device)
        self.hyai, self.hybi = t(hyai), t(hybi)
        # canonicalise to broadcast against out [B, L, ny]: accept [ny],
        # [L, ny], or already-leading-1 shapes
        if yscale_lev is not None:
            yscale_lev = t(yscale_lev)
            yscale_lev = yscale_lev.reshape(
                (1,) * max(0, 3 - yscale_lev.ndim)
                + tuple(yscale_lev.shape[-3:]))
            if yscale_lev.shape[0] != 1:
                raise ValueError(f"yscale_lev shape {tuple(yscale_lev.shape)}")
        self.yscale_lev = yscale_lev
        self.yscale_sca = None if yscale_sca is None \
            else t(yscale_sca).reshape(-1)
        # semi-online state normalization of the prognostic channels
        self.xmean_prog, self.xdiv_prog, self.lbd_qc, self.lbd_qi = (
            None if a is None else t(a)
            for a in (xmean_prog, xdiv_prog, lbd_qc, lbd_qi))
        self._schedule = optimizer_schedule(cfg)
        # the parameters the optimizer updates (``finetune.freeze`` takes
        # some out); every rebuilt optimizer takes the same ones
        self.trainable = list(model.parameters())
        self.opt = make_optimizer(cfg, self.trainable)
        self._last_W: int | None = None
        self.noise_source = noise_source if noise_source is not None \
            else KeyedNoise(cfg.seed, self.device)
        # the probabilistic loss's weight (0 before crps_start_epoch) and
        # the columns of the global batch this rank holds (cols, B), set
        # per epoch
        self._ens_w = 1.0
        self._noise_block = None

    def _set_epoch_state(self, epoch: int) -> None:
        self._ens_w = 0.0 if epoch < self.cfg.crps_start_epoch else 1.0

    def maybe_rescale_optimizer(self, W: int) -> None:
        """timestepped_optimizer: when the curriculum changes the window
        length, scale the LR by the window ratio and rebuild the optimizer
        (fresh state)."""
        if (self.cfg.timestepped_optimizer and self._last_W is not None
                and W != self._last_W):
            self.cfg.lr = self.cfg.lr * (W / self._last_W)
            self._schedule = optimizer_schedule(self.cfg)
            self.opt = make_optimizer(self.cfg, self.trainable)
        self._last_W = W

    def init(self, sample_window) -> torch.Tensor:
        """Fresh optimizer state, and the zero memory for the window's
        batch ([M, B, ...] for an ensemble; the JAX trainer's ``init``
        also initialises the parameters; here the model's constructor
        did)."""
        x_lev = sample_window["x_lev"][0]
        B, nlev = x_lev.shape[0], x_lev.shape[1]
        self.opt = make_optimizer(self.cfg, self.trainable)
        return torch.zeros(self._lead() + self._mem_shape(B, nlev),
                           dtype=torch.as_tensor(x_lev).dtype,
                           device=self.device)

    def _lead(self) -> tuple:
        M = self.cfg.ensemble_size
        return (M,) if M > 1 else ()

    # ------------------------------------------------------------------

    def _window_loss(self, window, mem, mix_mask, train: bool = True,
                     batch: GlobalBatch | None = None):
        """Loop over the window's W coupled steps; returns (total loss,
        new memory). ``batch`` takes the bias and GEL terms' batch
        reductions over every rank's columns."""
        cfg = self.cfg
        r0, r1 = cfg.replay_slice
        p0, p1 = cfg.pred_slice

        # static per-feature loss weights; None when both factors are 1
        w_lev = w_sfc = None
        if cfg.strat_temp_weight_factor != 1.0 \
                or cfg.scalar_weight_factor != 1.0:
            Lw, nyw = window["y_lev"].shape[2], window["y_lev"].shape[3]
            wl = torch.ones((Lw, nyw), device=self.device)
            wl[:cfg.strat_weight_levels, 0] *= cfg.strat_temp_weight_factor
            w_lev = wl
            w_sfc = torch.full((window["y_sfc"].shape[-1],),
                               cfg.scalar_weight_factor, device=self.device)

        def main_loss(out, y_lev, out_sfc, y_sfc):
            if w_lev is None:
                return L.LOSS_FNS[cfg.loss](out, y_lev) \
                    + L.LOSS_FNS[cfg.loss](out_sfc, y_sfc)
            return L.weighted_loss(out, y_lev, w_lev, kind=cfg.loss) \
                + L.weighted_loss(out_sfc, y_sfc, w_sfc, kind=cfg.loss)

        np_ = cfg.n_prog

        def normalize_prog(x_raw):
            """Raw prognostic state -> normalized input channels, with the
            exp cloud transform on qc/qi (rnn/utils.py:1038-1050)."""
            x = torch.clamp(x_raw, min=0.0)
            if self.lbd_qc is not None:
                qc = 1.0 - torch.exp(-x[..., 2] * self.lbd_qc)
                qi = 1.0 - torch.exp(-x[..., 3] * self.lbd_qi)
                x = torch.cat([x[..., :2], qc[..., None], qi[..., None],
                               x[..., 4:]], dim=-1)
            if self.xmean_prog is not None:
                x = (x - self.xmean_prog) / self.xdiv_prog
            return x

        M = cfg.ensemble_size
        ens_fn = _ensemble_score(cfg) if M > 1 else None
        model = self.model
        stochastic = getattr(model, "add_stochastic_layer", False)
        # AR(1) noise carried through the window (rollout.py:376-380)
        ar_noise = M > 1 and stochastic \
            and getattr(model, "ar_noise_rho", 0.0) > 0.0

        def members(x_lev, x_sfc, mem, eps_c, fresh):
            """The M members as one batch of M x B columns, member-major:
            (out [M, B, ...], out_sfc [M, B, ...], memory [M, B, ...],
            eps)."""
            B = x_lev.shape[0]
            fold = lambda a: a.repeat((M,) + (1,) * (a.dim() - 1))
            kw = {}
            if stochastic:
                kw = dict(deterministic=False, noise=fresh)
                if ar_noise:
                    kw["eps_prev"] = eps_c
            res = model(fold(x_lev), fold(x_sfc),
                        mem.reshape((M * B,) + tuple(mem.shape[2:])), **kw)
            unfold = lambda a: a.reshape((M, B) + tuple(a.shape[1:]))
            return unfold(res[0]), unfold(res[1]), unfold(res[2]), \
                (res[3] if ar_noise else eps_c)

        def step(mem, prev_out, have_prev, x_lev, x_sfc, y_lev, y_sfc, sp,
                 x_raw, eps_c=None, fresh=None, semi=None):
            if cfg.semi_online:
                # the dynamics increment of the true series, applied to the
                # model-advanced state (rnn/utils.py:1014-1056)
                x_pred, x_true_prev, y_true_prev, y_raw = semi
                dx_dyn = (x_raw[..., :np_] - x_true_prev) \
                    - DT_STEP * y_true_prev
                ysl = self.yscale_lev[..., :np_] \
                    if self.yscale_lev is not None else 1.0
                x_adv = x_pred + DT_STEP * (prev_out[..., :np_] / ysl) \
                    + dx_dyn
                use = have_prev * (mix_mask[:, None, None]
                                   if cfg.replay == "mixed" else 1.0)
                x_pred = use * x_adv + (1.0 - use) * x_raw[..., :np_]
                x_lev = torch.cat([normalize_prog(x_pred), x_lev[..., np_:]],
                                  dim=-1)
                semi = (x_pred.to(x_raw.dtype), x_raw[..., :np_],
                        y_raw[..., :np_])
            elif cfg.replay in ("full", "mixed"):
                use = have_prev * (mix_mask[:, None, None]
                                   if cfg.replay == "mixed" else 1.0)
                repl = use * prev_out[..., p0:p1] \
                    + (1.0 - use) * x_lev[..., r0:r1]
                x_lev = torch.cat([x_lev[..., :r0], repl, x_lev[..., r1:]],
                                  dim=-1)
            aux = None
            if M > 1:
                out_e, out_sfc_e, mem, eps_c = members(x_lev, x_sfc, mem,
                                                       eps_c, fresh)
                out, out_sfc = out_e.mean(0), out_sfc_e.mean(0)
                if self._ens_w < 1.0:
                    # before crps_start_epoch: the deterministic loss of
                    # the member mean
                    main = main_loss(out, y_lev, out_sfc, y_sfc)
                else:
                    main = ens_fn(out_e, y_lev) + ens_fn(out_sfc_e, y_sfc)
            else:
                if cfg.pass_y_true and train:
                    res = self._apply(model, x_lev, x_sfc, mem, x_raw,
                                      y_lev)
                else:
                    res = self._apply(model, x_lev, x_sfc, mem, x_raw)
                out, out_sfc, mem = res[:3]
                aux = res[3] if len(res) > 3 else None
                main = main_loss(out, y_lev, out_sfc, y_sfc)
            # the extra terms are summed apart and added to the weighted
            # main loss last, in the JAX trainer's order
            extra = 0.0
            if M > 1 and cfg.w_det > 0:
                # the member mean's squared error over the level and
                # surface outputs
                se = torch.sum(torch.square(out - y_lev)) \
                    + torch.sum(torch.square(out_sfc - y_sfc))
                extra = extra + cfg.w_det * se / (y_lev.numel()
                                                  + y_sfc.numel())
            if aux is not None and cfg.w_precip_neg > 0 \
                    and "prec_negative" in aux:
                extra = extra + cfg.w_precip_neg * torch.mean(
                    torch.square(aux["prec_negative"]))
            raw_terms = x_raw is not None and (
                cfg.w_qvpos > 0 or cfg.w_qnpos > 0 or cfg.w_rh > 0)
            if cfg.w_energy > 0 or cfg.w_water > 0 or cfg.w_cld > 0 \
                    or raw_terms:
                ys, yss = self.yscale_lev, self.yscale_sca
                od = out / ys if ys is not None else out
                osd = out_sfc / yss if yss is not None else out_sfc
                td = y_lev / ys if ys is not None else y_lev
                tsd = y_sfc / yss if yss is not None else y_sfc
                hy = (self.hyai, self.hybi)
                if cfg.w_energy > 0:
                    extra = extra + cfg.w_energy \
                        * conservation.energy_conservation_mse(
                            td, tsd, od, osd, sp, *hy)
                if cfg.w_water > 0:
                    extra = extra + cfg.w_water \
                        * conservation.water_conservation_mse(
                            od, osd, sp, *hy)
                if cfg.w_cld > 0:
                    cwp_p = conservation.cloud_water_path(od, sp, *hy)
                    cwp_t = conservation.cloud_water_path(td, sp, *hy)
                    extra = extra + cfg.w_cld * torch.mean(
                        torch.square(cwp_p - cwp_t))
                if raw_terms:
                    extra = extra + self._raw_state_terms(od, x_raw, sp)
            loss = cfg.w_main * main + extra
            return mem, out, out_sfc, loss, eps_c, semi

        run = step
        if cfg.remat and torch.is_grad_enabled():
            run = lambda *a: checkpoint(step, *a, use_reentrant=False)
        W = window["x_lev"].shape[0]
        prev_out = torch.zeros_like(window["y_lev"][0])
        have_prev = 0.0
        eps_c = None
        if ar_noise:
            B, nlev = window["x_lev"].shape[1], window["x_lev"].shape[2]
            Le, _, nh3 = model.noise_shape(B, nlev)
            eps_c = torch.zeros((Le, M * B, nh3),
                                dtype=window["x_lev"].dtype,
                                device=self.device)
        # the semi-online carry (x_pred, x_true_prev, y_true_prev) from zeros
        zprog = torch.zeros(tuple(window["x_lev"].shape[1:3]) + (np_,),
                            dtype=window["x_lev"].dtype, device=self.device)
        carry = (zprog, zprog, zprog) if cfg.semi_online else None
        raw = cfg.pass_x_raw or cfg.semi_online
        step_losses, outs, out_sfcs = [], [], []
        for i in range(W):
            # the draws come in as an argument, so that a remat recompute
            # reuses them
            fresh = self._draw(i, window) if M > 1 and stochastic else None
            semi = carry + (window["y_lev_raw"][i],) if cfg.semi_online \
                else None
            mem, prev_out, out_sfc, loss, eps_c, carry = run(
                mem, prev_out, have_prev, window["x_lev"][i],
                window["x_sfc"][i], window["y_lev"][i], window["y_sfc"][i],
                window["sp"][i], window["x_lev_raw"][i] if raw else None,
                eps_c, fresh, semi)
            have_prev = 1.0
            step_losses.append(loss)
            outs.append(prev_out)
            out_sfcs.append(out_sfc)
        loss = torch.stack(step_losses).mean()
        out_sfcs = torch.stack(out_sfcs)
        B = out_sfcs.shape[1]
        if cfg.w_bias > 0:
            outs = torch.stack(outs)
            loss = loss + cfg.w_bias * L.absolute_bias_loss(
                outs.reshape((-1,) + tuple(outs.shape[2:])),
                window["y_lev"].reshape((-1,)
                                        + tuple(window["y_lev"].shape[2:])),
                out_sfcs.reshape(W * B, -1),
                window["y_sfc"].reshape(W * B, -1),
                batch_nanmean=None if batch is None else batch.nanmean)
        if cfg.w_gel_precip > 0:
            loss = loss + cfg.w_gel_precip * L.gel_precip_loss(
                window["y_sfc"].reshape(W * B, -1),
                out_sfcs.reshape(W * B, -1), W, lam=cfg.gel_lambda,
                batch_mean=None if batch is None else batch.mean)
        if cfg.w_precip > 0:
            # accumulated-precipitation MSE over the window
            prec_pred = out_sfcs[..., 3].sum(0)
            prec_true = window["y_sfc"][..., 3].sum(0)
            loss = loss + cfg.w_precip * torch.mean(
                torch.square(prec_pred - prec_true)) / (W * W)
        return loss, mem

    def _draw(self, step: int, window) -> torch.Tensor:
        """The members' fresh draws for the window's step ``step``, member
        m at columns m B .. (m + 1) B: [Le, M B, nh3]. On a data-parallel
        rank each member's draw is made for the global batch and this
        rank's columns are taken, so the ranks together draw what one
        device draws."""
        B, nlev = window["x_lev"].shape[1], window["x_lev"].shape[2]
        cols, Bg = self._noise_block or (slice(None), B)
        shape = self.model.noise_shape(Bg, nlev)
        return torch.cat([self.noise_source(step, m, shape)[:, cols]
                          for m in range(self.cfg.ensemble_size)], dim=1)

    def _raw_state_terms(self, od, x_raw, sp):
        """The weighted raw-state terms of one step: the positivity of qv
        and of qn = qc + qi, and the RH consistency, after one DT_STEP of
        the raw tendencies ``od`` [B, L, ny] from the raw state ``x_raw``
        [B, L, C] with channels [T, qv, qc, qi, ...]."""
        cfg = self.cfg
        extra = 0.0
        if cfg.w_qvpos > 0:
            qv_new = x_raw[..., 1] + DT_STEP * od[..., 1]
            extra = extra + cfg.w_qvpos * torch.mean(
                torch.square(torch.relu(-qv_new)))
        if cfg.w_qnpos > 0:
            dqn = od[..., 2] if cfg.mp_mode in (1, -1) \
                else od[..., 2] + od[..., 3]
            qn_new = x_raw[..., 2] + x_raw[..., 3] + DT_STEP * dqn
            extra = extra + cfg.w_qnpos * torch.mean(
                torch.square(torch.relu(-qn_new)))
        if cfg.w_rh > 0:
            p_int = 1e5 * self.hyai[None] + self.hybi[None] * sp[:, None]
            pmid = 0.5 * (p_int[:, 1:] + p_int[:, :-1])
            extra = extra + cfg.w_rh * L.rh_consistency_loss(
                od[..., 1], od[..., 0], x_raw[..., 1], x_raw[..., 0], pmid,
                rh_max=cfg.rh_max)
        return extra

    def update(self, window, mem, mix_mask, group=None):
        """One optimizer update on one window: (detached new memory,
        detached loss). Autograd is on for it whatever the caller's mode.
        With a process ``group`` whose ranks each hold an equal block of
        the window's columns (and of the memory and mask), the loss is the
        global batch's: its batch terms reduce over every rank
        (``GlobalBatch``), and every gradient and the loss are averaged
        over the ranks in one ``all_reduce`` after the backward, before
        the step."""
        step = next((int(s["step"]) for s in self.opt.state.values()), 0)
        # soap and muon read their schedule at the 1-based count
        step += getattr(self.opt, "schedule_offset", 0)
        for g in self.opt.param_groups:
            g["lr"] = self._schedule(step)
        self.opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, new_mem = self._window_loss(
                window, mem, mix_mask,
                batch=None if group is None else GlobalBatch(group))
            loss.backward()
        if group is not None:
            loss = all_reduce_mean_(self.trainable, loss.detach(), group)
        self.opt.step()
        # the memory detaches here: the next window starts from its value
        return new_mem.detach(), loss.detach()

    def evaluate(self, window, mem, mix_mask):
        """The window's loss without an update: (new memory, loss)."""
        with torch.no_grad():
            loss, new_mem = self._window_loss(window, mem, mix_mask,
                                              train=False)
        return new_mem, loss

    # ------------------------------------------------------------------

    def _mix_mask(self, B: int, frac: float, gen: torch.Generator):
        """The replay mask of ``mixed`` replay: each column replays with
        probability ``frac``. The other modes never read it, so none is
        drawn (and nothing is copied to the device)."""
        if self.cfg.replay != "mixed":
            return None
        return (torch.rand(B, generator=gen) < frac).to(self.device,
                                                        torch.float32)

    def _fresh_mem(self, mem, chunk):
        """``mem``, or zeros where it does not fit the chunk's batch
        ([M, B, ...] for an ensemble)."""
        B = chunk["x_lev"].shape[1]
        lead = self._lead()
        if mem is None or tuple(mem.shape[:len(lead) + 1]) != lead + (B,):
            mem = torch.zeros(lead + self._mem_shape(
                B, chunk["x_lev"].shape[2]), dtype=torch.float32,
                device=self.device)
        return mem

    def _window(self, chunk, s: int, W: int) -> dict:
        """Steps s..s+W of a chunk on the device: a view where the chunk
        already lives there (the CLI's device cache), else one copy."""
        return {k: torch.as_tensor(v[s:s + W], device=self.device)
                for k, v in chunk.items()}

    def run_epoch(self, mem, chunks, epoch: int, train: bool = True,
                  generator: torch.Generator | None = None):
        """chunks: iterable of window dicts with time-major arrays
        [T, B, ...]; consecutive windows inside a chunk share memory.
        Returns (memory, record). The replay mix mask is drawn per window
        from ``generator`` (default: seeded with ``cfg.seed + epoch``)."""
        cfg = self.cfg
        W = cfg.window_for_epoch(epoch)
        frac = cfg.mix_fraction(epoch)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(cfg.seed + epoch)
        self._set_epoch_state(epoch)
        if train:
            self.maybe_rescale_optimizer(W)
        tot, n = 0.0, 0
        t0 = time.time()
        for chunk in chunks:
            T, B = chunk["x_lev"].shape[0], chunk["x_lev"].shape[1]
            mem = self._fresh_mem(mem, chunk)
            for s in range(0, T - W + 1, W):
                window = self._window(chunk, s, W)
                mix_mask = self._mix_mask(B, frac, gen)
                if train:
                    mem, loss = self.update(window, mem, mix_mask)
                else:
                    mem, loss = self.evaluate(window, mem, mix_mask)
                tot += float(loss)
                n += 1
        rec = {"epoch": epoch, "window": W, "mix_frac": frac,
               "loss": tot / max(n, 1), "updates": n,
               "seconds": time.time() - t0}
        return mem, rec


def run_epoch_fused(trainer: RolloutTrainer, mem, chunks, epoch: int,
                    generator: torch.Generator | None = None, mesh=None):
    """The training epoch of the CLI (``fused: true``, its default), the
    counterpart of JAX's one-dispatch-per-chunk epoch
    (``make_fused_chunk_step``): each chunk of T steps is cut into
    T // W windows (a remainder is dropped), ONE replay mask is drawn per
    chunk, and the windows are updated in order with the optimizer
    stepped after each; the loss is per window and the memory detaches at
    window edges, as in the per-window path. The host reads the loss once
    per chunk, as JAX's chunk scan returns it. Returns (memory, record)
    with JAX's keys: ``loss`` is the mean over chunks of each chunk's mean
    window loss, ``updates`` the windows updated, ``dispatches`` the
    chunks.

    With a ``mesh`` (a ``parallel.make_mesh`` over the ranks, one device
    each) the epoch is data-parallel over its 'data' axis, SPMD: every rank
    is given the same global chunks and the same trainer (parameters and
    optimizer state equal on every rank, e.g. through
    ``parallel.replicate``) and takes its block of each chunk's B columns
    (B must divide over the ranks); ``mem`` is this rank's block of the
    memory, and so is the memory returned. The replay mask is drawn over
    the global batch from the same generator on every rank, then sliced;
    so is an ensemble's noise, and an ensemble's memory [M, B, ...] is
    the rank's block on axis 1. Each update averages the gradients over the ranks after the backward
    (``RolloutTrainer.update(group=)``; no DDP hooks, which clash with the
    remat of ``torch.utils.checkpoint``), so the parameters stay equal
    and the epoch equals the single-device one on the global batch, its
    record included."""
    cfg = trainer.cfg
    W = cfg.window_for_epoch(epoch)
    frac = cfg.mix_fraction(epoch)
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(cfg.seed + epoch)
    trainer._set_epoch_state(epoch)
    trainer.maybe_rescale_optimizer(W)
    group, rank, nranks = None, 0, 1
    if mesh is not None:
        group = mesh.get_group("data")
        rank, nranks = axis_rank(mesh, "data")
    tot, n, updates = 0.0, 0, 0
    t0 = time.time()
    for chunk in chunks:
        T, B = chunk["x_lev"].shape[0], chunk["x_lev"].shape[1]
        nw = T // W
        if nw == 0:
            continue
        if B % nranks:
            raise ValueError(f"{B} columns do not divide over {nranks} "
                             f"ranks of 'data'")
        b = B // nranks
        cols = slice(rank * b, (rank + 1) * b)
        if mesh is not None:
            chunk = {k: v[:, cols] for k, v in chunk.items()}
        mem = trainer._fresh_mem(mem, chunk)
        mix_mask = trainer._mix_mask(B, frac, gen)
        if mix_mask is not None:
            mix_mask = mix_mask[cols]
        trainer._noise_block = (cols, B) if mesh is not None else None
        losses = []
        try:
            for i in range(nw):
                mem, loss = trainer.update(trainer._window(chunk, i * W, W),
                                           mem, mix_mask, group=group)
                losses.append(loss)
        finally:
            trainer._noise_block = None
        tot += float(torch.stack(losses).mean())
        n += 1
        updates += nw
    rec = {"epoch": epoch, "window": W, "mix_frac": frac,
           "loss": tot / max(n, 1), "updates": updates,
           "dispatches": n, "seconds": time.time() - t0}
    return mem, rec


# ---------------------------------------------------------------- checkpoint

def save_rollout_checkpoint(path: str, trainer: RolloutTrainer, mem,
                            epoch: int, val_loss: float | None = None,
                            keep_top_k: int = 3) -> str:
    """Best-K checkpoint retention: ``{path}/ep{epoch}.pt`` holds the
    model's and the optimizer's state dicts, the schedule's state (the
    base learning rate, which ``timestepped_optimizer`` rescales, and the
    last window length), the autoregressive memory and the epoch;
    ``index.json`` lists the kept entries ({"name": "ep{epoch}", "epoch",
    "val_loss"}) sorted by validation loss, as the JAX package's does, and
    the files of entries past ``keep_top_k`` are deleted."""
    os.makedirs(path, exist_ok=True)
    name = f"ep{epoch}"
    torch.save({"model": trainer.model.state_dict(),
                "optimizer": trainer.opt.state_dict(),
                "schedule": {"lr": trainer.cfg.lr,
                             "last_window": trainer._last_W},
                "mem": mem, "epoch": epoch},
               os.path.join(path, f"{name}.pt"))
    index_path = os.path.join(path, "index.json")
    index = []
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
    index = [e for e in index if e["name"] != name]
    index.append({"name": name, "epoch": epoch,
                  "val_loss": val_loss if val_loss is not None else 1e30})
    index.sort(key=lambda e: e["val_loss"])
    for stale in index[keep_top_k:]:
        stale_file = os.path.join(path, f"{stale['name']}.pt")
        if os.path.exists(stale_file):
            os.remove(stale_file)
    index = index[:keep_top_k]
    with open(index_path, "w") as f:
        json.dump(index, f)
    return name


def restore_rollout_checkpoint(path: str, trainer: RolloutTrainer,
                               name: str | None = None):
    """Load the best (or named) checkpoint into ``trainer``'s model,
    optimizer and schedule; returns (memory on the trainer's device,
    epoch)."""
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    entry = index[0] if name is None else \
        next(e for e in index if e["name"] == name)
    ck = torch.load(os.path.join(path, f"{entry['name']}.pt"),
                    map_location=trainer.device, weights_only=True)
    trainer.model.load_state_dict(ck["model"])
    trainer.cfg.lr = ck["schedule"]["lr"]
    trainer._schedule = optimizer_schedule(trainer.cfg)
    trainer._last_W = ck["schedule"]["last_window"]
    trainer.opt = make_optimizer(trainer.cfg, trainer.trainable)
    trainer.opt.load_state_dict(ck["optimizer"])
    return ck["mem"], ck["epoch"]
