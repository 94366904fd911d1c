"""The offline training loop for flat emulators (counterpart of
``climsim_tpu/train/loop.py``): one update a batch (forward, backward,
global-norm clipping, the learning rate of the update's count, the
optimizer's step), per-epoch validation with a quick R2, best-checkpoint
retention, ReduceLROnPlateau on the validation loss, early stopping and
the two-strikes NaN abort.

The optimizer follows optax, not torch's defaults, where they differ:

* ``optax.clip_by_global_norm`` scales every gradient by max_norm / norm
  when norm >= max_norm (no epsilon; ``clip_grad_norm_`` adds 1e-6):
  ``clip_by_global_norm_`` does it by hand, on the device;
* the learning-rate schedules are optax's formulas, evaluated at the
  update's count before each update (``cosine`` gives 0 at the first
  update, whose Adam moments still move);
* optax's ``adamw`` decays the weights inside the update (-lr (u + wd p))
  and torch's ``AdamW`` first (p (1 - lr wd)), from the same p: equal up
  to rounding;
* the plateau rule scales the learning rate to max(lr x factor, min_lr)
  and keeps the moments (JAX's ``inject_hyperparams``): here it sets the
  optimizer's ``param_group["lr"]``.

A ``TrainState`` holds the model (updated in place), its optimizer and
the update count; checkpoints are torch files. The model's initial
parameters come from its constructor's seed (JAX's ``init_state`` draws
them from ``FitConfig.seed``, which this FitConfig does not have).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from .. import variables as V
from . import losses as L
from .schedules import (one_cycle, step_decay, warmup_constant,
                        warmup_cosine_decay)


@dataclass
class FitConfig:
    lr: float = 1e-3
    weight_decay: float = 0.0
    optimizer: str = "adam"          # adam | adamw | soap | muon
    loss: str = "huber"
    epochs: int = 10
    batch_size: int = 1536
    nan_strikes: int = 2             # abort after N non-finite epochs
    # global-norm gradient clipping
    max_grad_norm: float | None = None
    # per-step LR schedule: None | 'cosine' | 'onecycle' | 'step' |
    # 'warmup'
    lr_schedule: str | None = None
    schedule_steps: int = 10000
    warmup_steps: int = 200
    lr_gamma: float = 0.95
    decay_every: int = 1000
    # epoch-level ReduceLROnPlateau on the val loss; adam/adamw
    plateau_patience: int | None = None
    plateau_factor: float = 0.5
    min_lr: float = 0.0
    # stop when the val loss has not improved for N epochs
    early_stop_patience: int | None = None
    log_path: str | None = None      # JSONL metric log
    var_weights: dict = field(default_factory=dict)


def make_schedule(cfg: FitConfig) -> Callable[[int], float] | None:
    """The learning rate as a function of the update count, or None for
    a constant one (which the plateau rule may then scale)."""
    if cfg.lr_schedule is None:
        return None
    if cfg.lr_schedule == "cosine":
        warm = min(cfg.warmup_steps, cfg.schedule_steps // 2)
        return warmup_cosine_decay(0.0, cfg.lr, warm, cfg.schedule_steps,
                                   end_value=cfg.min_lr)
    if cfg.lr_schedule == "onecycle":
        return one_cycle(cfg.lr, cfg.schedule_steps)
    if cfg.lr_schedule == "step":
        return step_decay(cfg.lr, cfg.decay_every, cfg.lr_gamma)
    if cfg.lr_schedule == "warmup":
        return warmup_constant(cfg.lr, cfg.warmup_steps)
    raise ValueError(cfg.lr_schedule)


def make_optimizer(cfg: FitConfig, params) -> torch.optim.Optimizer:
    """optax's adam/adamw as torch optimizers with optax's defaults (b1
    0.9, b2 0.999, eps 1e-8), or the JAX package's soap and muon
    (``train/soap.py``, ``train/muon.py``), at the schedule's first
    learning rate; the training step clips the gradients before each of
    them, as JAX chains ``clip_by_global_norm`` before each."""
    if cfg.plateau_patience:
        if cfg.lr_schedule is not None:
            raise ValueError("plateau excludes a per-step lr_schedule")
        if cfg.optimizer not in ("adam", "adamw"):
            raise ValueError(f"plateau supports adam/adamw, "
                             f"not {cfg.optimizer}")
    sched = make_schedule(cfg)
    lr_at = lambda count: cfg.lr if sched is None else sched(count)
    if cfg.optimizer == "soap":
        from .soap import SOAP
        return SOAP(params, lr=lr_at(SOAP.schedule_offset),
                    weight_decay=cfg.weight_decay)
    if cfg.optimizer == "muon":
        from .muon import Muon
        return Muon(params, lr=lr_at(Muon.schedule_offset),
                    weight_decay=cfg.weight_decay)
    lr = lr_at(0)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")


@dataclass
class TrainState:
    """The ``flax.training.TrainState`` counterpart: the model (its
    parameters are updated in place), the optimizer and the number of
    updates made."""
    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def init_state(model: nn.Module, cfg: FitConfig) -> TrainState:
    """A fresh optimizer over ``model``'s parameters, which its
    constructor initialised from its seed."""
    return TrainState(model, make_optimizer(cfg, model.parameters()))


def zero_missing_grads_(params) -> list[torch.Tensor]:
    """Give every parameter the loss did not reach a zero gradient, as
    JAX's ``grad`` gives one to every leaf of the tree (a frozen
    ``IdentityConv``, an RPN prior): Adam then leaves it exactly as it
    is and ``adamw`` decays it, as optax does. Returns the gradients."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    return grads


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm in place: g -> g / norm x max_norm for
    every g where the global norm is not below ``max_norm``; no host
    synchronisation."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_train_step(vset: V.VariableSet, cfg: FitConfig,
                    device) -> Callable:
    """``step(state, x, y) -> (state, loss)``: one update on the batch
    (on ``device``, the model's) with the per-variable weighted loss,
    ``cfg``'s clipping and the schedule's learning rate at the update's
    count; the loss stays on the device. Autograd is on for it whatever
    the caller's mode."""
    feat_w = torch.as_tensor(L.block_weights(vset, cfg.var_weights),
                             device=device)
    schedule = make_schedule(cfg)

    def step(state: TrainState, x, y):
        model, opt = state.model, state.opt
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = L.weighted_loss(model(x), y, feat_w, cfg.loss)
            loss.backward()
        grads = zero_missing_grads_(p for g in opt.param_groups
                                    for p in g["params"])
        if cfg.max_grad_norm:
            clip_by_global_norm_(grads, cfg.max_grad_norm)
        if schedule is not None:
            # soap and muon read the schedule at the 1-based count
            at = state.step + getattr(opt, "schedule_offset", 0)
            for g in opt.param_groups:
                g["lr"] = schedule(at)
        opt.step()
        state.step += 1
        return state, loss.detach()

    return step


def make_eval_step(vset: V.VariableSet, cfg: FitConfig,
                   device) -> Callable:
    """``step(state, x, y) -> (loss, mean R2 over features, pred)`` on
    scaled outputs on ``device``, without gradients."""
    feat_w = torch.as_tensor(L.block_weights(vset, cfg.var_weights),
                             device=device)

    def step(state: TrainState, x, y):
        with torch.no_grad():
            pred = state.model(x)
            loss = L.weighted_loss(pred, y, feat_w, cfg.loss)
            ss_res = torch.sum(torch.square(pred - y), dim=0)
            ss_tot = torch.sum(torch.square(y - y.mean(dim=0)), dim=0)
            r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=1e-30)
        return loss, torch.mean(r2), pred

    return step


def _scale_lr(opt: torch.optim.Optimizer, factor: float, min_lr: float):
    """ReduceLROnPlateau: lr -> max(lr x factor, min_lr), moments kept."""
    for g in opt.param_groups:
        g["lr"] = max(g["lr"] * factor, min_lr)


def fit(model: nn.Module, vset: V.VariableSet, cfg: FitConfig,
        train_batches: Callable[[], Iterable], val_batches=None,
        checkpoint_dir: str | None = None,
        state: TrainState | None = None) -> tuple[TrainState, list[dict]]:
    """Run the training loop; returns (state, one record a epoch).

    ``train_batches``/``val_batches``: zero-argument callables returning
    an iterable of (x, y) batches (numpy arrays or tensors; moved to the
    model's device) per epoch. The losses are summed on the device and
    read once an epoch. JAX's ``fit`` also draws one batch before the
    first epoch to initialise the parameters; the port's model has them,
    so ``train_batches`` is called once an epoch only."""
    if state is None:
        state = init_state(model, cfg)
    dev = next(state.model.parameters()).device
    on_dev = lambda a: torch.as_tensor(a, device=dev)
    tstep = make_train_step(vset, cfg, dev)
    estep = make_eval_step(vset, cfg, dev)

    history, strikes, best_val = [], 0, np.inf
    bad_epochs = 0
    for epoch in range(cfg.epochs):
        t0 = time.time()
        tot, nb = 0.0, 0
        for x, y in train_batches():
            state, loss = tstep(state, on_dev(x), on_dev(y))
            tot = tot + loss.double()
            nb += 1
        train_loss = float(tot) / max(nb, 1)

        rec = {"epoch": epoch, "train_loss": train_loss,
               "seconds": time.time() - t0}
        if val_batches is not None:
            vtot, vr2, vn = 0.0, 0.0, 0
            for x, y in val_batches():
                vl, r2v, _ = estep(state, on_dev(x), on_dev(y))
                vtot = vtot + vl.double()
                vr2 = vr2 + r2v.double()
                vn += 1
            rec["val_loss"] = float(vtot) / max(vn, 1)
            rec["val_r2"] = float(vr2) / max(vn, 1)
            if rec["val_loss"] < best_val:
                best_val = rec["val_loss"]
                bad_epochs = 0
                if checkpoint_dir:
                    save_checkpoint(checkpoint_dir, state, epoch)
            else:
                bad_epochs += 1
                if cfg.plateau_patience and \
                        bad_epochs >= cfg.plateau_patience:
                    _scale_lr(state.opt, cfg.plateau_factor, cfg.min_lr)
                    rec["lr_reduced"] = True
                    bad_epochs = 0
        history.append(rec)
        stop = (cfg.early_stop_patience and val_batches is not None
                and len(history) - 1 - int(np.argmin(
                    [h.get("val_loss", np.inf) for h in history]))
                >= cfg.early_stop_patience)
        if stop:
            rec["early_stop"] = True
        if cfg.log_path:
            with open(cfg.log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

        # NaN two-strikes abort
        if not np.isfinite(train_loss):
            strikes += 1
            if strikes >= cfg.nan_strikes:
                raise FloatingPointError(
                    f"non-finite training loss {cfg.nan_strikes} times; abort")
        else:
            strikes = 0
        if stop:
            break
    return state, history


# ---------------------------------------------------------------- checkpoint

def save_checkpoint(path: str, state: TrainState, epoch: int):
    """``{path}/ep{epoch}.pt``: the model's and the optimizer's state
    dicts and the update count; ``latest.txt`` names it."""
    os.makedirs(path, exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.opt.state_dict(), "step": state.step},
               os.path.join(path, f"ep{epoch}.pt"))
    with open(os.path.join(path, "latest.txt"), "w") as f:
        f.write(f"ep{epoch}")


def restore_checkpoint(path: str, state: TrainState) -> tuple[TrainState,
                                                               int]:
    """Load the latest checkpoint into ``state``'s model and optimizer;
    returns (state, its epoch)."""
    with open(os.path.join(path, "latest.txt")) as f:
        name = f.read().strip()
    dev = next(state.model.parameters()).device
    ck = torch.load(os.path.join(path, f"{name}.pt"), map_location=dev,
                    weights_only=True)
    state.model.load_state_dict(ck["model"])
    state.opt.load_state_dict(ck["optimizer"])
    state.step = ck["step"]
    return state, int(name[2:])
