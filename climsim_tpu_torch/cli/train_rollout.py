"""Rollout RNN trainer CLI for the memory BiGRU and the physics-constrained
emulator (counterpart of ``climsim_tpu/cli/train_rollout.py``).

Usage:
    python -m climsim_tpu_torch.cli.train_rollout conf/autoreg_gru.yaml \\
        [model.nh_mem=32 rollout.replay=mixed device=cpu ...]

It reads the same yamls and overrides as the JAX CLI and builds the same
data, normalization, model and trainer, with these differences:

* ``device`` (default ``cuda``) says where it runs; without a card it
  raises unless given ``device=cpu``. JAX's ``platform=cpu`` is taken as
  ``device=cpu``; any other ``platform`` raises.
* The yaml is read by the port's own reader (``train/config.py``), by
  YAML 1.2's rules: ``w_wcon: 3.0e7`` is the float 3e7, where PyYAML's
  YAML 1.1 reading gives the JAX CLI a string.
* ``grid_path`` defaults to ``cli.run_hybrid.DEFAULT_GRID``, relative to
  the working directory.
* Initial weights come from ``seed`` through the model's constructor.
  ``init_from`` takes a torch file written by this package (a state dict
  or a checkpoint ``ep{N}.pt``); JAX's orbax checkpoints cross over
  through ``models.convert.from_flax_params``. Checkpoints are torch files
  (``train/rollout.py::save_rollout_checkpoint``).
* ``model.scan_unroll`` (an XLA unrolling hint) is accepted and has no
  effect.
* Every model option of the JAX CLI runs: ``model.cell`` (gru, lstm,
  ln_lstm, sru, qrnn), ``model.memory: None`` and
  ``model.separate_radiation`` (its memory on the CRM's 50 bottom levels,
  as JAX's trainer keeps it).
* ``model.stochastic_cell`` (sgru | slstm) is read, where the JAX CLI
  always builds its default sgru; ``sln_lstm`` raises ``ValueError`` when
  the model is built, because JAX's model cannot run it
  (``models/rnn.py::SLN_LSTM_FAULT``).
* An ensemble run (``rollout.ensemble_size > 1``) carries the memory
  [M, B, ...], which the JAX CLI's scoreboard and export feed to the
  model as [B, ...], so they fail there; here ``eval_report``,
  ``eval_report_every``, ``pred_export`` and ``export_path`` raise
  ``ValueError`` with an ensemble before any data is built. The members'
  noise comes from the trainer's ``noise_source`` (by default keyed by
  ``seed``, the step in the window and the member, as JAX's keys are).
* ``plots_dir`` without matplotlib prints that no plot was made, where
  the JAX CLI prints any exception of its plot and goes on.
* ``export_path`` writes a ``torch.export`` program (``.pt2``, loaded by
  ``export.load_step``) of the trained model's forward, where the JAX CLI
  writes StableHLO.

The normalized series live on the card when they fit in 4 GiB
(``data.device_cache: auto``), and the epochs then chunk them there.
"""
from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

# the keys of the input preprocessing chain (data/preprocess.py)
PP_KEYS = ("snowhice_fix", "rh_prune", "rh_input_to_q", "include_q_input",
           "v4_to_v5_inputs", "cld_inp_transformation", "qinput_prune",
           "qinput_prune_lev")
# pbuf_* previous-physics surface channels of the v4_rnn scalar block
PAST_SFC = (17, 18, 19, 20, 21)
DEVICE_CACHE_BYTES = 4 * 1024 ** 3


ENSEMBLE_REFUSES = ("eval_report", "eval_report_every", "pred_export",
                    "export_path")


def check_unported(cfg) -> None:
    """Raise for the outputs an ensemble run cannot give, before any data
    is built (every model option runs)."""
    rcfg = cfg.get("rollout", {})
    if rcfg.get("ensemble_size", 1) > 1:
        for key in ENSEMBLE_REFUSES:
            if cfg.get(key):
                raise ValueError(
                    f"{key} runs the model on the [B, ...] memory; an "
                    f"ensemble's is [M, B, ...] (the JAX CLI fails there "
                    f"too)")


def cli_device(cfg) -> torch.device:
    """``device`` (default cuda; raises without a card), or JAX's
    ``platform=cpu``."""
    from ..ops import resolve_device
    platform = cfg.get("platform")
    if platform is not None and platform != "cpu":
        raise ValueError(f"platform={platform!r}: this CLI takes "
                         f"device=cuda|cpu (platform=cpu means device=cpu)")
    device = cfg.get("device", "cpu" if platform == "cpu" else "cuda")
    return resolve_device(device)


@dataclass
class Series:
    """The raw time-major series [T, B, ...] as float32 tensors, and where
    the training steps end (``n_train_steps``, set by a separate
    validation file)."""
    x_lev: torch.Tensor
    x_sfc: torch.Tensor
    y_lev: torch.Tensor
    y_sfc: torch.Tensor
    n_train_steps: int | None = None
    # data.stream: rows read on demand (KeeplevReader.load_slice)
    stream_read: object = None
    stream_T: int | None = None


def _h5_series(path: str, B: int, max_steps: int | None = None):
    from ..data import KeeplevReader
    r = KeeplevReader(path)
    T = r.n // B
    if max_steps is not None:
        T = min(T, max_steps)
        d = r.load_slice(0, T * B)
    else:
        d = r.load_all()
    resh = lambda a: torch.from_numpy(
        np.ascontiguousarray(a[:T * B].reshape((T, B) + a.shape[1:])))
    return (resh(d["input_lev"]), resh(d["input_sca"]),
            resh(d["output_lev"]), resh(d["output_sca"]))


def load_data(cfg, grid, vset) -> Series:
    """The keeplev H5 file of ``data.h5_path`` (and ``data.val_h5_path``,
    appended after the training steps), or a synthetic time series of
    ``data.steps`` steps at ``data.ncol`` columns generated on the grid's
    device from ``data.seed``. ``data.stream`` reads a bounded sample for
    the statistics and streams the epochs."""
    dcfg = cfg.get("data", {})
    if dcfg.get("h5_path"):
        B = dcfg.get("ncol", 384)
        if dcfg.get("stream", False):
            if dcfg.get("val_h5_path"):
                raise ValueError("data.stream does not support a separate "
                                 "val_h5_path; use val_frac over one store")
            from ..data import KeeplevReader
            reader = KeeplevReader(dcfg["h5_path"])
            arrays = _h5_series(dcfg["h5_path"], B,
                                int(dcfg.get("stats_steps", 64)))
            return Series(*arrays, stream_read=reader.load_slice,
                          stream_T=reader.n // B)
        arrays = _h5_series(dcfg["h5_path"], B)
        if not dcfg.get("val_h5_path"):
            return Series(*arrays)
        val = _h5_series(dcfg["val_h5_path"], B)
        return Series(*(torch.cat([a, b]) for a, b in zip(arrays, val)),
                      n_train_steps=arrays[0].shape[0])
    from ..data import synthetic as S
    arrays = S.make_timeseries(
        torch.Generator().manual_seed(int(dcfg.get("seed", 0))),
        S.SyntheticConfig(vset_name=vset.name, ncol=dcfg.get("ncol", 384)),
        grid, dcfg.get("steps", 24), flat=False)
    return Series(*arrays)


@dataclass
class Prep:
    """The input preprocessing chain of the ``data`` keys in PP_KEYS and
    ``remove_past_sfc_inputs``, with its cloud-transform lambdas."""
    pcfg: object = None
    lbd_qc: np.ndarray | None = None
    lbd_qi: np.ndarray | None = None
    lbd_qn: np.ndarray | None = None
    remove_past_sfc: bool = False
    hyam: np.ndarray | None = None
    hybm: np.ndarray | None = None

    def __call__(self, xl, xs):
        """(x_lev, x_sfc) -> (x_lev, x_lev raw, x_sfc), tensors or numpy
        arrays in, the same kind out (on the host when the chain runs)."""
        xr = xl
        if self.pcfg is not None:
            from ..data.preprocess import preprocess_level_inputs
            tensors = isinstance(xl, torch.Tensor)
            host = lambda a: a.cpu().numpy() if tensors else a
            xl, xr, xs = preprocess_level_inputs(
                host(xl), host(xs), self.hyam, self.hybm, self.pcfg,
                lbd_qc=self.lbd_qc, lbd_qi=self.lbd_qi, lbd_qn=self.lbd_qn)
            if tensors:
                xl, xr, xs = (torch.from_numpy(a) for a in (xl, xr, xs))
        if self.remove_past_sfc:
            keep = [i for i in range(xs.shape[-1]) if i not in PAST_SFC]
            xs = xs[..., keep]
        return xl, xr, xs


def make_prep(cfg, grid, series: Series) -> Prep:
    """The chain the yaml asks for; lambdas loaded from ``data.lbd_*_path``
    or fitted on the (sample) series."""
    dcfg = cfg.get("data", {})
    prep = Prep(remove_past_sfc=bool(dcfg.get("remove_past_sfc_inputs")),
                hyam=grid.hyam.cpu().numpy(), hybm=grid.hybm.cpu().numpy())
    if not any(k in dcfg for k in PP_KEYS):
        return prep
    from ..data.preprocess import PreprocessConfig
    from ..data.normalization import fit_exp_lambdas, load_exp_lambdas
    prep.pcfg = PreprocessConfig(**{k: dcfg[k] for k in PP_KEYS if k in dcfg})
    if prep.pcfg.cld_inp_transformation == "exp":
        for tag in ("qn", "qc", "qi"):
            if dcfg.get(f"lbd_{tag}_path"):
                setattr(prep, f"lbd_{tag}",
                        load_exp_lambdas(dcfg[f"lbd_{tag}_path"]))
        xl = series.x_lev.cpu().numpy()
        if prep.pcfg.v4_to_v5_inputs and prep.lbd_qn is None:
            prep.lbd_qn = fit_exp_lambdas(xl[..., 2] + xl[..., 3])
        if not prep.pcfg.v4_to_v5_inputs:
            if prep.lbd_qc is None:
                prep.lbd_qc = fit_exp_lambdas(xl[..., 2])
            if prep.lbd_qi is None:
                prep.lbd_qi = fit_exp_lambdas(xl[..., 3])
    return prep


@dataclass
class Norm:
    """Input means and divisors (level [L or 1, C] or [C], surface [C])
    and output scales, float32 tensors on the series' device."""
    xm: torch.Tensor
    xsd: torch.Tensor
    xms: torch.Tensor
    xss: torch.Tensor
    ysc_lev: torch.Tensor
    ysc_sfc: torch.Tensor


def fit_norm(cfg, vset, x_lev, x_sfc, y_lev, y_sfc) -> Norm:
    """``data.norm: reference``: the ClimSim norm files assembled as the
    reference's hydra trainer does (the paths printed, and written next to the
    checkpoints); otherwise statistics of the series: per-level input
    mean and std (``input_norm_per_level``), output scale 1 / std(|y|)
    (``output_norm_per_level``), population std as numpy's."""
    dcfg = cfg.get("data", {})
    dev = x_lev.device
    if dcfg.get("norm") == "reference":
        from ..data.normalization import (reference_level_normalizer,
                                          reference_norm_paths)
        args = (dcfg.get("norm_input_mean"), dcfg.get("norm_input_max"),
                dcfg.get("norm_input_min"), dcfg.get("norm_output_scale"))
        nz = reference_level_normalizer(
            vset, *args, snowhice_fix=bool(dcfg.get("snowhice_fix", True)),
            remove_past_sfc=bool(dcfg.get("remove_past_sfc_inputs", False)))
        prov = reference_norm_paths(*args)
        print(json.dumps({"norm_files": prov}))
        if cfg.get("checkpoint_dir"):
            os.makedirs(cfg["checkpoint_dir"], exist_ok=True)
            with open(os.path.join(cfg["checkpoint_dir"], "norm_files.json"),
                      "w") as f:
                json.dump(prov, f, indent=1)
        nz = nz.to(dev)
        if nz.mean_lev.shape[1] != x_lev.shape[-1] \
                or nz.mean_sfc.shape[0] != x_sfc.shape[-1]:
            raise ValueError(
                f"data.norm=reference coefficient shapes "
                f"{tuple(nz.mean_lev.shape)}/{tuple(nz.mean_sfc.shape)} do "
                f"not match data {tuple(x_lev.shape)}/{tuple(x_sfc.shape)}; "
                f"check vset/preprocessing flags")
        return Norm(nz.mean_lev, nz.div_lev, nz.mean_sfc, nz.div_sfc,
                    nz.scale_lev, nz.scale_sfc)
    std = lambda a, dims: a.std(dims, correction=0)
    lev_dims = (0, 1) if dcfg.get("input_norm_per_level", True) \
        else (0, 1, 2)
    xm, xsd = x_lev.mean(lev_dims), std(x_lev, lev_dims) + 1e-8
    xms, xss = x_sfc.mean((0, 1)), std(x_sfc, (0, 1)) + 1e-8
    if dcfg.get("output_norm_per_level", True):
        ysc_lev = 1.0 / (std(y_lev.abs(), (0, 1)) + 1e-12)
    else:
        ysc_lev = (1.0 / (std(y_lev.abs(), (0, 1, 2)) + 1e-12)).expand(
            y_lev.shape[2:]).clone()
    ysc_sfc = 1.0 / (std(y_sfc.abs(), (0, 1)) + 1e-12)
    return Norm(xm, xsd, xms, xss, ysc_lev, ysc_sfc)


def n_prev(dcfg, key: str, default_n: int) -> int:
    """Previous-step channel count: true means the reference's count."""
    v = dcfg.get(key, 0)
    return default_n if v is True else int(v or 0)


def build_model(cfg, grid, nx: int, nx_sfc: int, ny: int, ny_sfc: int,
                norm: Norm, device):
    """The model of ``model.type`` (rnn | physrnn) with the yaml's options,
    its weights from ``seed``."""
    from ..models import BF16, F32
    mcfg = cfg.get("model", {})
    tt = lambda a: tuple(float(x) for x in a.detach().cpu().numpy())
    policy = BF16 if str(mcfg.get("policy", "f32")).lower() == "bf16" \
        else F32
    xms, xss = norm.xms.cpu().numpy(), norm.xss.cpu().numpy()
    seed = int(cfg.get("seed", 0))
    if mcfg.get("type", "rnn") == "physrnn":
        from ..models.phys_rnn import PhysicalRNNAutoreg
        ysl2 = norm.ysc_lev.cpu().numpy().astype(np.float32)
        ysl = ysl2.reshape(-1, ysl2.shape[-1]).mean(0)
        if ysl2.ndim == 2 and mcfg.get("per_level_yscale", False):
            # per-level columns clipped to 100x around their median
            def ycol(c):
                col = ysl2[:, c]
                med = float(np.median(col))
                return tuple(float(v) for v in
                             np.clip(col, med / 100.0, med * 100.0))
        else:
            ycol = lambda c: float(ysl[c])
        return PhysicalRNNAutoreg(
            nx=nx, nx_sfc=nx_sfc, ny=ny, ny_sfc=ny_sfc,
            nneur=tuple(mcfg.get("nneur", (128, 128))),
            nh_mem=mcfg.get("nh_mem", 16), nreg=mcfg.get("nreg", 8),
            store_precip=mcfg.get("store_precip", True),
            ice_sedimentation=mcfg.get("ice_sedimentation", True),
            use_physrad=mcfg.get("use_physrad", False),
            separate_radiation=mcfg.get("separate_radiation", False),
            add_pres=mcfg.get("add_pres", False),
            update_states_for_rad=mcfg.get("update_states_for_rad", True),
            use_mcica=mcfg.get("use_mcica", False),
            use_tc=mcfg.get("use_tc", False),
            use_qv_variability=mcfg.get("use_qv_variability", False),
            use_pallas=mcfg.get("use_pallas", False),
            learned_cloud_optics=mcfg.get("learned_cloud_optics", False),
            ng_lw=mcfg.get("ng_lw", 8), ng_sw=mcfg.get("ng_sw", 8),
            hyai=tt(grid.hyai), hybi=tt(grid.hybi),
            hyam=tt(grid.hyam), hybm=tt(grid.hybm),
            sp_mean=float(xms[0]), sp_div=float(xss[0]),
            yscale_t=ycol(0), yscale_qv=ycol(1), yscale_qn=ycol(2),
            yscale_precc=float(norm.ysc_sfc[3]), policy=policy,
            device=device, seed=seed)
    from ..models.rnn import RNNAutoreg
    return RNNAutoreg(
        nx=nx, nx_sfc=nx_sfc, ny=ny, ny_sfc=ny_sfc,
        nneur=tuple(mcfg.get("nneur", (192, 192))),
        nh_mem=mcfg.get("nh_mem", 16),
        # the reference's `memory: None` is the non-autoregressive model
        use_memory=str(mcfg.get("memory", "Hidden")).lower() != "none",
        cell=mcfg.get("cell", "gru"),
        add_stochastic_layer=mcfg.get("add_stochastic_layer", False),
        stochastic_cell=mcfg.get("stochastic_cell", "sgru"),
        # the AR(1) noise modes: 0 uncorrelated, 1/2 correlated in time
        # with vertical structure, 3 one draw for every level; rho 0.5
        # for a correlated mode unless given
        ar_noise_rho=mcfg.get(
            "ar_noise_rho", 0.5 if mcfg.get("ar_noise_mode", 0) > 0 else 0.0),
        ar_noise_vertical=mcfg.get("ar_noise_mode", 0) != 3,
        separate_radiation=mcfg.get("separate_radiation", False),
        use_pallas=mcfg.get("use_pallas", False),
        output_prune=mcfg.get("output_prune", True),
        add_pres=mcfg.get("add_pres", True),
        scan_unroll=mcfg.get("scan_unroll", 1),
        hyam=tt(grid.hyam), hybm=tt(grid.hybm),
        sp_mean=float(xms[0]), sp_div=float(xss[0]), policy=policy,
        device=device, seed=seed)


def rollout_config(cfg, need_raw: bool):
    """RolloutConfig from the yaml's rollout, optimizer and loss blocks."""
    from ..train.rollout import RolloutConfig
    rcfg, ocfg = cfg.get("rollout", {}), cfg.get("optimizer", {})
    lcfg, mcfg = cfg.get("loss", {}), cfg.get("model", {})
    rc = RolloutConfig(
        rollout_schedule={int(k): v for k, v in
                          rcfg.get("schedule", {0: 1, 3: 2, 6: 3}).items()},
        loss=lcfg.get("name", "huber"),
        lr=ocfg.get("lr", 1e-3),
        optimizer=ocfg.get("name", "adam"),
        weight_decay=ocfg.get("weight_decay", 0.0),
        lr_schedule=ocfg.get("schedule"),
        schedule_steps=ocfg.get("schedule_steps", 10000),
        scheduler_max_lr=ocfg.get("scheduler_max_lr"),
        scheduler_min_lr=ocfg.get("scheduler_min_lr"),
        scheduler_pct_start=ocfg.get("scheduler_pct_start", 0.3),
        scheduler_annealing=ocfg.get("scheduler_annealing", "cos"),
        lr_gamma=ocfg.get("lr_gamma", 0.95),
        decay_every=ocfg.get("decay_every", 1000),
        warmup_steps=ocfg.get("warmup_steps", 200),
        w_main=lcfg.get("w_main", 1.0),
        w_energy=lcfg.get("w_hcon", 0.0),
        w_water=lcfg.get("w_wcon", 0.0),
        w_precip=lcfg.get("w_precip", 0.0),
        w_gel_precip=lcfg.get("w_gel_precip", 0.0),
        gel_lambda=lcfg.get("gel_lambda", 1.0),
        w_bias=lcfg.get("w_bias", 0.0),
        w_rh=lcfg.get("w_rh", 0.0),
        rh_max=lcfg.get("rh_max", 1.05),
        w_qvpos=lcfg.get("w_qvpos", 0.0),
        w_qnpos=lcfg.get("w_qnpos", 0.0),
        mp_mode=lcfg.get("mp_mode", 1),
        w_cld=lcfg.get("w_cld", 0.0),
        w_precip_neg=lcfg.get("w_precip_neg", 0.0),
        w_det=lcfg.get("w_det", 0.0),
        strat_temp_weight_factor=lcfg.get("strat_temp_weight_factor", 1.0),
        scalar_weight_factor=lcfg.get("scalar_weight_factor", 1.0),
        replay=rcfg.get("replay"),
        replay_slice=tuple(rcfg.get("replay_slice", (9, 14))),
        pred_slice=tuple(rcfg.get("pred_slice", (0, 5))),
        gradual_mixing_end_epoch=rcfg.get("gradual_mixing_end_epoch", 10),
        pass_x_raw=need_raw,
        remat=rcfg.get("remat", False),
        ensemble_size=rcfg.get("ensemble_size", 1),
        ens_loss=rcfg.get("ens_loss", "crps"),
        ens_sumvar=rcfg.get("crps_sumvar", False),
        ens_beta=rcfg.get("beta", 1.0),
        crps_start_epoch=rcfg.get("crps_start_epoch", 0),
        timestepped_optimizer=ocfg.get("timestepped", False))
    if mcfg.get("type", "rnn") == "physrnn":
        # training-mode teacher forcing of the radiation state
        rc.pass_y_true = bool(mcfg.get("use_physrad", False)
                              and mcfg.get("update_states_for_rad", True))
    return rc


@dataclass
class Run:
    """Everything an epoch loop needs: the trainer, the chunk source
    ``chunks(lo, hi, shuffle, seed=0)``, the train/validation split and
    the output scales, with the grid and variable set."""
    cfg: object
    trainer: object
    chunks: object
    ntr: int
    norm: Norm
    grid: object
    vset: object
    is_phys: bool


def setup(cfg) -> Run:
    """Build the data, normalization, model, trainer and chunk source that
    the JAX CLI builds from ``cfg``."""
    from .. import variables as V
    from ..grid import Grid
    from ..train.rollout import RolloutTrainer, phys_apply, phys_mem_shape
    from .run_hybrid import DEFAULT_GRID

    check_unported(cfg)
    device = cli_device(cfg)
    vset = V.get(cfg.get("vset", "v4_rnn"))
    grid = Grid.from_file(cfg.get("grid_path", DEFAULT_GRID), device=device)
    dcfg = cfg.get("data", {})
    mcfg = cfg.get("model", {})
    lcfg = cfg.get("loss", {})
    is_phys = mcfg.get("type", "rnn") == "physrnn"

    series = load_data(cfg, grid, vset)
    prep = make_prep(cfg, grid, series)
    x_lev, x_raw, x_sfc = prep(series.x_lev, series.x_sfc)
    y_lev, y_sfc = series.y_lev, series.y_sfc
    norm = fit_norm(cfg, vset, x_lev, x_sfc, y_lev, y_sfc)
    sp = x_sfc[..., 0]
    x_lev_n = (x_lev - norm.xm) / norm.xsd
    x_sfc_n = (x_sfc - norm.xms) / norm.xss
    y_lev_n = y_lev * norm.ysc_lev
    y_sfc_n = y_sfc * norm.ysc_sfc
    ipi = n_prev(dcfg, "include_prev_inputs", 6)
    ipo = n_prev(dcfg, "include_prev_outputs", 5)
    # the raw level state: the physics model's forward and the
    # state-consistency loss terms read it
    need_raw = (is_phys or lcfg.get("w_rh", 0.0) > 0
                or lcfg.get("w_qvpos", 0.0) > 0
                or lcfg.get("w_qnpos", 0.0) > 0)
    dims = (x_lev.shape[-1] + ipi + ipo, x_sfc.shape[-1], y_lev.shape[-1],
            y_sfc.shape[-1])
    stream_read, stream_T = series.stream_read, series.stream_T
    stream = stream_read is not None
    T = stream_T if stream else x_lev.shape[0]
    ntr = series.n_train_steps if series.n_train_steps is not None \
        else int(T * (1 - dcfg.get("val_frac", 0.2)))
    cached = [x_lev_n, x_sfc_n, y_lev_n, y_sfc_n, sp] \
        + ([x_raw] if need_raw else [])
    dev_cache = dcfg.get("device_cache", "auto")
    if dev_cache == "auto":
        dev_cache = sum(a.numel() * 4 for a in cached) <= DEVICE_CACHE_BYTES
    if stream:
        dev_cache = False          # chunks move through the bounded pipeline
    home = device if dev_cache else torch.device("cpu")
    x_lev_n, x_sfc_n, y_lev_n, y_sfc_n, sp, *raw = (
        a.to(home, torch.float32) for a in cached)
    x_raw = raw[0] if need_raw else None
    del series, x_lev, y_lev, cached, raw

    model = build_model(cfg, grid, *dims, norm, device)
    h = lambda t: t.cpu().numpy()
    trainer = RolloutTrainer(
        model, rollout_config(cfg, need_raw), h(grid.hyai), h(grid.hybi),
        yscale_lev=h(norm.ysc_lev)[None, None], yscale_sca=h(norm.ysc_sfc),
        apply_fn=phys_apply if is_phys else None,
        mem_shape=phys_mem_shape(model) if is_phys else None, device=device)

    chunk = dcfg.get("chunk_size", 8)
    chunks = _stream_chunks(cfg, stream_read, stream_T, prep, norm, ipi, ipo,
                            need_raw, chunk, device) if stream else \
        _mem_chunks(x_lev_n, x_sfc_n, y_lev_n, y_sfc_n, sp, x_raw, ipi, ipo,
                    need_raw, chunk)
    return Run(cfg, trainer, chunks, ntr, norm, grid, vset, is_phys)


def _mem_chunks(x_lev_n, x_sfc_n, y_lev_n, y_sfc_n, sp, x_raw, ipi, ipo,
                need_raw, chunk):
    """The chunk source over the held series."""
    from ..data import keeplev_chunks

    def chunks(lo, hi, shuffle, seed=0):
        n = (hi if hi is not None else x_lev_n.shape[0]) - lo
        # prev-step channels consume the first step of each split
        if ipi or ipo:
            n = n - 1
        cs = max(1, min(chunk, n))
        sl = slice(lo, hi)
        if not need_raw:
            yield from keeplev_chunks(
                x_lev_n[sl], x_sfc_n[sl], y_lev_n[sl], y_sfc_n[sl], sp[sl],
                chunk_size=cs, shuffle=shuffle, seed=seed,
                include_prev_inputs=ipi, include_prev_outputs=ipo)
            return
        # with the raw state the chunks stay in time order (the raw slice
        # is matched by position); previous-step channels shift each
        # chunk's start by one step, and the raw slice with it
        off = 1 if (ipi or ipo) else 0
        for i, c in enumerate(keeplev_chunks(
                x_lev_n[sl], x_sfc_n[sl], y_lev_n[sl], y_sfc_n[sl], sp[sl],
                chunk_size=cs, shuffle=False, include_prev_inputs=ipi,
                include_prev_outputs=ipo)):
            c["x_lev_raw"] = x_raw[sl][off + i * cs:off + (i + 1) * cs]
            yield c
    return chunks


def _stream_chunks(cfg, read, n_steps_total, prep, norm, ipi, ipo, need_raw,
                   chunk, device):
    """The chunk source of ``data.stream``: chunks read from the store by a
    background thread, normalized on the host after the raw predecessor
    row is read (so the previous-step channels come from normalized
    arrays, as in memory), and copied to the device ahead of use."""
    from ..data import stream_keeplev_chunks
    dcfg = cfg.get("data", {})
    B = dcfg.get("ncol", 384)
    h = lambda t: t.cpu().numpy()
    xm, xsd, xms, xss = h(norm.xm), h(norm.xsd), h(norm.xms), h(norm.xss)
    ysl, yss = h(norm.ysc_lev), h(norm.ysc_sfc)

    def raw_tf(xl, xs, yl, ys, off):
        xl, xr, xs = prep(xl, xs)
        xln, xsn = (xl - xm) / xsd, (xs - xms) / xss
        yln, ysn = yl * ysl, ys * yss
        xl_c = xln[off:] if off else xln
        if ipo:
            xl_c = np.concatenate([xl_c, yln[:-1][..., :ipo]], axis=-1)
        if ipi:
            xl_c = np.concatenate([xl_c, xln[:-1][..., :ipi]], axis=-1)
        d = {"x_lev": xl_c, "x_sfc": xsn[off:], "y_lev": yln[off:],
             "y_sfc": ysn[off:], "sp": xs[off:, :, 0]}
        if need_raw:
            d["x_lev_raw"] = xr[off:]
        return {k: np.ascontiguousarray(v, np.float32) for k, v in d.items()}

    def chunks(lo, hi, shuffle, seed=0):
        hi = n_steps_total if hi is None else hi
        n = hi - lo - (1 if (ipi or ipo) else 0)
        yield from stream_keeplev_chunks(
            read, n_steps_total, B, chunk_size=max(1, min(chunk, n)),
            seed=seed, shuffle=shuffle, include_prev_inputs=ipi,
            include_prev_outputs=ipo, raw_transform=raw_tf,
            prefetch=int(dcfg.get("stream_prefetch", 2)), to_device=True,
            device=device, t_start=lo, t_stop=hi)
    return chunks


def initial_memory(run: Run):
    """Fresh optimizer state and the zero memory of the first training
    chunk's batch."""
    first = next(iter(run.chunks(0, run.ntr, False)))
    if not run.is_phys:
        return run.trainer.init(first)
    B, L = first["x_lev"].shape[1], first["x_lev"].shape[2]
    return torch.zeros(run.trainer._mem_shape(B, L), dtype=torch.float32,
                       device=run.trainer.device)


def load_weights(run: Run, mem):
    """``resume`` (the best retained checkpoint; returns its memory and
    the next epoch) or ``init_from`` (a partial load of a donor torch file,
    then ``freeze_patterns``). Returns (memory, first epoch)."""
    cfg = run.cfg
    ckpt = cfg.get("checkpoint_dir")
    if ckpt and cfg.get("resume"):
        from ..train.rollout import restore_rollout_checkpoint
        mem, ep0 = restore_rollout_checkpoint(ckpt, run.trainer)
        print(f"resumed from {ckpt} at epoch {ep0}")
        return mem, ep0 + 1
    if cfg.get("init_from"):
        from ..train.finetune import freeze, partial_load
        donor = torch.load(cfg["init_from"], map_location=run.trainer.device,
                           weights_only=True)
        if isinstance(donor.get("model"), dict):     # a checkpoint ep{N}.pt
            donor = donor["model"]
        nl, ns = partial_load(run.trainer.model, donor)
        print(f"init_from: loaded {nl} tensors, kept {ns}")
        if cfg.get("freeze_patterns"):
            freeze(run.trainer, list(cfg["freeze_patterns"]))
    return mem, 0


def eval_scoreboard(run: Run, mem):
    """Run the model over the validation split step by step from the
    training memory and compute the scoreboard (train/epoch_metrics).
    Returns (metrics, (pred_lev, pred_sfc, true_lev, true_sfc, sp)) in raw
    units, tensors on the device."""
    from ..train.epoch_metrics import epoch_metrics
    tr, model = run.trainer, run.trainer.model
    ysl, yss = run.norm.ysc_lev.to(tr.device), run.norm.ysc_sfc.to(tr.device)
    pl_, ps_, tl_, ts_, sps = [], [], [], [], []
    mem_e = None
    with torch.no_grad():
        for c in run.chunks(run.ntr, None, False):
            c = {k: torch.as_tensor(v, device=tr.device) for k, v in c.items()}
            if mem_e is None:
                mem_e = mem if mem is not None else torch.zeros(
                    tr._mem_shape(c["x_lev"].shape[1], c["x_lev"].shape[2]),
                    device=tr.device)
            for t in range(c["x_lev"].shape[0]):
                xr = c["x_lev_raw"][t] if run.is_phys else None
                out, osfc, mem_e = tr._apply(model, c["x_lev"][t],
                                             c["x_sfc"][t], mem_e, xr)[:3]
                pl_.append(out / ysl)
                ps_.append(osfc / yss)
                tl_.append(c["y_lev"][t] / ysl)
                ts_.append(c["y_sfc"][t] / yss)
                sps.append(c["sp"][t])
    arrays = tuple(torch.cat(a) for a in (pl_, ps_, tl_, ts_, sps))
    met = epoch_metrics(*arrays, run.grid.hyai, run.grid.hybi)
    return met, arrays


def _log(cfg, obj) -> None:
    if cfg.get("log_path"):
        with open(cfg["log_path"], "a") as f:
            f.write(json.dumps(obj) + "\n")


def train(run: Run, mem, start_epoch: int):
    """The epoch loop: fused training epochs (``fused``, default true),
    validation from ``val_epoch_start``, the scoreboard every
    ``eval_report_every`` epochs, best-K checkpoints. Returns (memory,
    records, exit code: 2 on a non-finite loss)."""
    from ..train.rollout import run_epoch_fused, save_rollout_checkpoint
    cfg, tr = run.cfg, run.trainer
    ckpt = cfg.get("checkpoint_dir")
    report_every = int(cfg.get("eval_report_every", 0))
    records = []
    for epoch in range(start_epoch, cfg.get("epochs", 10)):
        train_chunks = run.chunks(0, run.ntr, True, seed=epoch)
        if cfg.get("fused", True):
            mem, rec = run_epoch_fused(tr, mem, train_chunks, epoch)
        else:
            mem, rec = tr.run_epoch(mem, train_chunks, epoch)
        if epoch >= cfg.get("val_epoch_start", 0):
            _, vrec = tr.run_epoch(None, run.chunks(run.ntr, None, False),
                                   epoch, train=False)
            rec["val_loss"] = vrec["loss"]
        else:
            rec["val_loss"] = rec["loss"]
        if report_every and (epoch + 1) % report_every == 0:
            met, _ = eval_scoreboard(run, mem)
            rec.update({k: v for k, v in met.items() if k != "r2_lev"})
        print(json.dumps(rec))
        _log(cfg, rec)
        records.append(rec)
        if not np.isfinite(rec["loss"]):
            print("non-finite loss; aborting (two-strikes policy)")
            return mem, records, 2
        if ckpt:
            save_rollout_checkpoint(ckpt, tr, mem, epoch,
                                    val_loss=float(rec["val_loss"]),
                                    keep_top_k=cfg.get("keep_top_k", 3))
    return mem, records, 0


def final_report(run: Run, mem) -> None:
    """``eval_report`` (the validation scoreboard, printed and logged,
    and with ``plots_dir`` the per-level R2 profile of every output
    channel, ``val_r2_profile.png``) and ``pred_export`` (teacher-forced one-step predictions over the
    validation split in the flat registry layout, raw units:
    scoring_{pred,target,ps}.npy)."""
    cfg = run.cfg
    cache = None
    if cfg.get("eval_report"):
        cache = eval_scoreboard(run, mem)
        met = cache[0]
        print(json.dumps({"eval_report": {k: v for k, v in met.items()
                                          if k != "r2_lev"}}))
        _log(cfg, {"eval_report": met})
        if cfg.get("plots_dir"):
            plot_r2_profile(cfg["plots_dir"], cache[1][0], cache[1][2])
    pred_dir = cfg.get("pred_export")
    if pred_dir:
        from ..data.ingest import keeplev_to_flat
        os.makedirs(pred_dir, exist_ok=True)
        _, arrays = cache if cache is not None else eval_scoreboard(run, mem)
        PL, PS, TL, TS, SP = (a.cpu().numpy() for a in arrays)
        outs = run.vset.outputs
        np.save(os.path.join(pred_dir, "scoring_pred.npy"),
                keeplev_to_flat(PL, PS, outs))
        np.save(os.path.join(pred_dir, "scoring_target.npy"),
                keeplev_to_flat(TL, TS, outs))
        np.save(os.path.join(pred_dir, "scoring_ps.npy"),
                np.asarray(SP, np.float32))
        print(f"pred_export: wrote scoring_{{pred,target,ps}}.npy to "
              f"{pred_dir}")


class _PhysStep(torch.nn.Module):
    """The physics model's forward with the raw level state, its first
    three outputs (the exported step of ``type: physrnn``)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x_lev, x_sfc, mem, x_raw):
        return self.model(x_lev, x_sfc, mem, x_raw)[:3]


def export_model(run: Run, mem) -> None:
    """``export_path``: the trained model's forward as a ``torch.export``
    program (the deployment artifact, weights baked in) at the first
    training step's shapes: (x_lev, x_sfc, mem), the memory being the
    training memory or zeros, and for ``physrnn`` the raw level state as
    well, keeping the outputs [:3]."""
    from ..export.serialize import export_step
    path = run.cfg["export_path"]
    tr = run.trainer
    first = next(iter(run.chunks(0, run.ntr, False)))
    arg = lambda k: torch.as_tensor(first[k][0], dtype=torch.float32,
                                    device=tr.device)
    xm0, xs0 = arg("x_lev"), arg("x_sfc")
    m0 = mem.detach() if mem is not None else torch.zeros(
        tr._mem_shape(xm0.shape[0], xm0.shape[1]), device=tr.device)
    if run.is_phys:
        n = export_step(_PhysStep(tr.model), (xm0, xs0, m0, arg("x_lev_raw")),
                        path)
    else:
        n = export_step(tr.model, (xm0, xs0, m0), path)
    print(f"exported {n} bytes of torch.export program to {path}")


def plot_r2_profile(pdir: str, pred, true) -> None:
    """The validation R2 of each level and output channel (pred/true
    [N, L, ny]) as ``{pdir}/val_r2_profile.png``; without matplotlib it
    prints that no plot was made."""
    os.makedirs(pdir, exist_ok=True)
    try:
        from ..metrics.plots import profile_plot
        r2 = 1.0 - ((pred - true) ** 2).sum(0) / torch.clamp(
            ((true - true.mean(0)) ** 2).sum(0), min=1e-30)
        profile_plot({f"ch{j}": r2[:, j] for j in range(r2.shape[1])},
                     metric_name="R2",
                     save_path=os.path.join(pdir, "val_r2_profile.png"))
    except ImportError as e:
        print(f"(no plot: {e})")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    from ..train.config import load_config
    cfg = load_config(argv[0], argv[1:])
    run = setup(cfg)
    mem = initial_memory(run)
    mem, start = load_weights(run, mem)
    mem, _, rc = train(run, mem, start)
    if rc:
        return rc
    final_report(run, mem)
    if cfg.get("export_path"):
        export_model(run, mem)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
