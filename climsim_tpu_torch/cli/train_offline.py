"""Offline baseline trainer CLI (counterpart of
``climsim_tpu/cli/train_offline.py``): one YAML config and dotted
overrides train an offline emulator on the flat contract and print one
JSON record an epoch and the validation block's scoreboard.

Usage:
    python -m climsim_tpu_torch.cli.train_offline conf/mlp_v1.yaml \\
        [model.name=cnn optimizer.lr=3e-4 data.steps=100 device=cpu ...]

``model.name`` picks the arm, as in JAX:

* ``mlp``, ``cnn``, ``ed`` and ``unet`` (the ClimSim-Online U-Net; its
  inputs remapped to [profiles, scalars, location index] and its targets
  to [profiles, scalars]) train through ``train/loop.py::fit`` and end in
  the weighted scoreboard;
* ``hsr``, ``rpn`` and ``cvae`` (``train_stochastic``): each its own loss
  (HSR's NLL after an MSE warm phase of the first third of the epochs,
  the ensemble's MSE, the beta-ELBO), plain Adam at ``optimizer.lr``,
  batches from ``flat_batches(..., seed=epoch)``, records
  ``{"epoch", "train_loss"}``, and the scoreboard with CRPS over
  ``num_crps_samples`` samples. They ignore ``optimizer.{name,
  schedule, max_grad_norm}``, ``checkpoint_dir`` and ``metrics_csv``,
  and RPN ignores ``num_crps_samples`` (its members are its samples), as
  JAX's do;
* ``classifier`` and ``classifier_gradout`` (``train_classifier``): the
  cloud-state U-Net on labels from the raw cloud water and its tendency,
  Adam after global-norm clipping at ``optimizer.max_grad_norm``,
  unshuffled batches, records ``{"epoch", "train_ce", "val_ce"}`` (with
  ``max_grad``, ``mean_grad_l2`` and ``total_norm`` for the gradout
  variant), ``checkpoint_dir``'s ``classifier.pt``, ``init_from`` (that
  file, or the directory holding it) restored through
  ``train/finetune.py::partial_load``, and the per-class accuracy line.

It reads the same yamls and overrides as the JAX CLI and builds the same
data, normalization, models and loops, with these differences:

* ``device`` (default ``cuda``) says where it runs; without a card it
  raises unless given ``device=cpu``; JAX's ``platform=cpu`` is taken as
  ``device=cpu``.
* The synthetic series is made on the card (``data/synthetic.py::
  make_timeseries`` from ``data.seed``), normalized there and kept
  there: each batch is cut on the card from the same
  ``default_rng(seed)`` permutation as ``data/loader.py::flat_batches``
  draws, so no batch is copied from the host.
* JAX draws each epoch's shuffle seed for ``fit`` from numpy's global,
  unseeded generator; here it comes from ``np.random.default_rng(seed)``,
  so a run repeats.
* ``grid_path`` defaults to ``cli.run_hybrid.DEFAULT_GRID``, relative to
  the working directory.
* Initial weights come from ``seed`` through the model's constructor;
  checkpoints (``checkpoint_dir``) are torch files.
* The stochastic arms' draws (the cVAE's eps at each update, its z and
  eps at sampling, HSR's eps at sampling) come from a ``noise_source(what,
  shape)``, by default ``SeededNoise``: one generator on the device
  seeded from ``seed`` (Philox, not JAX's threefry, so the draws differ
  from JAX's; the tests feed JAX's in).
* The CNN and the U-Nets train without dropout, as JAX's loops call them
  (deterministic).
* ``optimizer.name`` soap and muon run the port's ``train/soap.py`` and
  ``train/muon.py``.
"""
from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

# rows of the time-major flat arrays per step (the low-res grid's columns)
NCOL = 384
STOCHASTIC = ("hsr", "rpn", "cvae")
CLASSIFIERS = ("classifier", "classifier_gradout")
CLASSIFIER_FILE = "classifier.pt"


def build_model(name: str, vset, mcfg, device, seed: int = 0):
    """The model of ``model.name`` with the yaml's options, its weights
    from ``seed``. The stochastic and classifier models are float32, as
    JAX builds them."""
    from .. import models as M
    policy = M.BF16 if mcfg.get("bf16", False) else M.F32
    nx, ny = vset.input_feature_len, vset.target_feature_len
    kw = dict(device=device, seed=seed)
    if name == "mlp":
        return M.mlp_for(vset, features=tuple(mcfg.get(
            "features", (768, 640, 512, 640, 640))), policy=policy, **kw)
    if name == "cnn":
        return M.CNN(depth=mcfg.get("depth", 12),
                     channels=mcfg.get("channels", 406), policy=policy, **kw)
    if name == "ed":
        return M.ED(nx, ny, latent_dim=mcfg.get("latent_dim", 5),
                    intermediate_dim=mcfg.get("intermediate_dim", 463),
                    policy=policy, **kw)
    if name == "unet":
        return M.ClimsimUNet(
            num_vars_profile=vset.inputs.n_lev_vars,
            num_vars_scalar=vset.inputs.n_sfc_vars,
            num_vars_profile_out=vset.outputs.n_lev_vars,
            num_vars_scalar_out=vset.outputs.n_sfc_vars,
            model_channels=mcfg.get("model_channels", 128),
            channel_mult=tuple(mcfg.get("channel_mult", (1, 2, 2, 2))),
            num_blocks=mcfg.get("num_blocks", 4),
            output_prune=mcfg.get("output_prune", True),
            loc_embedding=mcfg.get("loc_embedding", False), policy=policy,
            **kw)
    if name == "hsr":
        return M.HSR(nx, ny, hidden=mcfg.get("hidden", 512),
                     layers=mcfg.get("layers", 1), **kw)
    if name == "rpn":
        return M.RPNEnsemble(nx, ny, features=tuple(mcfg.get(
            "features", (768, 640, 512, 640, 640))),
            num_members=mcfg.get("members", 8), **kw)
    if name == "cvae":
        return M.CVAE(nx, ny, latent_dim=mcfg.get("latent_dim", 5),
                      hidden=mcfg.get("hidden", 512),
                      layers=mcfg.get("layers", 2), **kw)
    if name in CLASSIFIERS:
        return M.ClimsimUNetClassifier(
            vset.inputs.n_lev_vars, vset.inputs.n_sfc_vars,
            model_channels=mcfg.get("model_channels", 64),
            channel_mult=tuple(mcfg.get("channel_mult", (1, 2, 2))),
            num_blocks=mcfg.get("num_blocks", 2),
            loc_embedding=mcfg.get("loc_embedding", False), **kw)
    raise ValueError(f"unknown offline model {name}")


def unet_flat_remap(vset, xn: torch.Tensor) -> torch.Tensor:
    """The registry's flat inputs -> the U-Net's [profiles (by variable),
    scalars, location index 1..384 of each row's column]."""
    inl = vset.inputs
    idx = np.concatenate(
        [np.arange(inl.slices[n].start, inl.slices[n].stop)
         for n in inl.lev_names] + [[inl.slices[n].start
                                     for n in inl.sfc_names]])
    loc = (torch.arange(len(xn), device=xn.device) % NCOL + 1).to(xn.dtype)
    return torch.cat([xn[:, torch.as_tensor(idx, device=xn.device)],
                      loc[:, None]], dim=1)


def unet_target_remap(vset, yn: torch.Tensor) -> torch.Tensor:
    """The registry's flat targets -> the U-Net's [profiles, scalars]."""
    outl = vset.outputs
    idx = np.concatenate(
        [np.arange(outl.slices[n].start, outl.slices[n].stop)
         for n in outl.lev_names] + [[outl.slices[n].start
                                      for n in outl.sfc_names]])
    return yn[:, torch.as_tensor(idx, device=yn.device)]


def classifier_labels(vset, x_raw, y_raw, mcfg) -> torch.Tensor:
    """[N, 1, L] cloud labels from the raw cloud water and its tendency:
    v5 carries qn and ptend_qn, the other sets the liquid and ice
    channels, summed."""
    from ..models import cloud_class_labels
    inl, outl = vset.inputs, vset.outputs
    if "state_qn" in inl.lev_names:
        qn = x_raw[:, inl.slices["state_qn"]]
        dq = y_raw[:, outl.slices["ptend_qn"]]
    else:
        qn = (x_raw[:, inl.slices["state_q0002"]]
              + x_raw[:, inl.slices["state_q0003"]])
        dq = (y_raw[:, outl.slices["ptend_q0002"]]
              + y_raw[:, outl.slices["ptend_q0003"]])
    return cloud_class_labels(qn + 1200.0 * dq, dq,
                              mcfg.get("threshold_class1", 1e-9),
                              mcfg.get("threshold_class2", 1e-11))[:, None]


class SeededNoise:
    """The stochastic arms' default noise source: ``(what, shape) ->`` a
    standard-normal float32 draw from one ``torch.Generator`` on
    ``device`` seeded with ``seed``, in the order asked. ``what`` names
    the draw: "update" (the cVAE's eps [B, latent] at each update),
    "sample_z" and "sample_eps" (the cVAE's [S, N, latent] and
    [S, N, ny] at sampling; HSR's eps [N, ny, S])."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))

    def __call__(self, what: str, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.gen.device)


def fit_config(cfg):
    """FitConfig from the yaml's optimizer block and top-level keys."""
    from ..train import FitConfig
    ocfg = cfg.get("optimizer", {})
    return FitConfig(lr=ocfg.get("lr", 1e-3),
                     optimizer=ocfg.get("name", "adam"),
                     weight_decay=ocfg.get("weight_decay", 0.0),
                     loss=cfg.get("loss", "huber"),
                     epochs=cfg.get("epochs", 10),
                     batch_size=cfg.get("batch_size", 1536),
                     log_path=cfg.get("log_path"),
                     max_grad_norm=ocfg.get("max_grad_norm"),
                     lr_schedule=ocfg.get("schedule"),
                     schedule_steps=ocfg.get("schedule_steps", 10000),
                     warmup_steps=ocfg.get("warmup_steps", 200),
                     lr_gamma=ocfg.get("lr_gamma", 0.95),
                     decay_every=ocfg.get("decay_every", 1000),
                     plateau_patience=ocfg.get("plateau_patience"),
                     plateau_factor=ocfg.get("plateau_factor", 0.5),
                     min_lr=ocfg.get("min_lr", 0.0),
                     early_stop_patience=cfg.get("early_stop_patience"),
                     var_weights=cfg.get("var_weights", {}))


@dataclass
class Offline:
    """What ``main`` trains and scores: the raw flat series x [N, nx]
    (for ps), the normalized xn, yn on the device (remapped for the
    U-Nets), the normalizer, the first validation row ``ntr``, the model,
    its FitConfig, the grid and variable set, the classifier's labels
    [N, 1, L], and after training the records (with each epoch's
    ``seconds``) and the validation block's scoreboard frame (``scores``;
    None for the classifiers and where the block holds no whole step)."""
    cfg: object
    x: torch.Tensor
    xn: torch.Tensor
    yn: torch.Tensor
    nz: object
    ntr: int
    model: object
    fc: object
    grid: object
    vset: object
    labels: torch.Tensor | None = None
    history: list = field(default_factory=list)
    scores: object = None

    @property
    def name(self) -> str:
        return self.cfg.get("model", {}).get("name", "mlp")

    def train_batches(self, rng: np.random.Generator):
        """One training epoch's batches, shuffled by a seed from ``rng``."""
        from ..data import flat_batches
        return flat_batches(self.xn[:self.ntr], self.yn[:self.ntr],
                            self.fc.batch_size,
                            seed=int(rng.integers(1 << 31)))

    def val_batches(self):
        from ..data import flat_batches
        return flat_batches(self.xn[self.ntr:], self.yn[self.ntr:],
                            self.fc.batch_size, shuffle=False,
                            drop_remainder=False)


def setup(cfg) -> Offline:
    """The data, normalization and model the JAX CLI builds from
    ``cfg``, on the device."""
    from .. import variables as V
    from ..data import Normalizer
    from ..data import synthetic as S
    from ..grid import Grid
    from .run_hybrid import DEFAULT_GRID
    from .train_rollout import cli_device

    device = cli_device(cfg)
    vset = V.get(cfg.get("vset", "v1"))
    grid = Grid.from_file(cfg.get("grid_path", DEFAULT_GRID), device=device)
    dcfg = cfg.get("data", {})
    mcfg = cfg.get("model", {})
    xs, ys = S.make_timeseries(
        torch.Generator().manual_seed(int(dcfg.get("seed", 0))),
        S.SyntheticConfig(vset_name=vset.name), grid, dcfg.get("steps", 40))
    x = xs.reshape(-1, vset.input_feature_len)
    y = ys.reshape(-1, vset.target_feature_len)
    h = lambda t: t.cpu().numpy()
    nz = Normalizer.from_arrays(
        h(x.mean(0)), h(x.amax(0)), h(x.amin(0)),
        h(1.0 / (y.abs().std(0, correction=0) + 1e-12))).to(device)
    xn, yn = nz.normalize_input(x), nz.scale_output(y)
    ntr = int(len(xn) * (1 - dcfg.get("val_frac", 0.2))) // NCOL * NCOL
    name = mcfg.get("name", "mlp")
    labels = None
    if name == "unet":
        xn, yn = unet_flat_remap(vset, xn), unet_target_remap(vset, yn)
    elif name in CLASSIFIERS:
        labels = classifier_labels(vset, x, y, mcfg)
        xn = unet_flat_remap(vset, xn)
    model = build_model(name, vset, mcfg, device,
                        seed=int(cfg.get("seed", 0)))
    return Offline(cfg, x, xn, yn, nz, ntr, model, fit_config(cfg), grid,
                   vset, labels)


def validation_rows(run: Offline):
    """(first, last + 1, T) of the validation block's whole steps, or
    None when it holds none."""
    nval = (len(run.xn) - run.ntr) // NCOL * NCOL
    if nval <= 0:
        return None
    return run.ntr, run.ntr + nval, nval // NCOL


def validation_block(run: Offline):
    """(pred, target, ps_raw) of the validation block's whole steps,
    [T, NCOL, ny], [T, NCOL, ny] and [T, NCOL], or None when it holds
    none."""
    rows = validation_rows(run)
    if rows is None:
        return None
    lo, hi, T = rows
    with torch.no_grad():
        pred = run.model(run.xn[lo:hi])
    return (pred.reshape(T, NCOL, -1), run.yn[lo:hi].reshape(T, NCOL, -1),
            run.x[lo:hi, run.vset.ps_index].reshape(T, NCOL))


def score(run: Offline):
    """The weighted scoreboard of the validation block
    (``metrics.scoreboard``'s dict), or None when it holds no whole
    step."""
    from ..metrics import scoreboard
    block = validation_block(run)
    if block is None:
        return None
    return scoreboard(*block, run.vset, run.grid, scale=run.nz.scale)


def stochastic_loss(run: Offline, noise):
    """The HSR, RPN or cVAE arm's training loss, ``(xb, yb, epoch) ->``
    a scalar: HSR's NLL (MSE while ``epoch`` is in the first third), the
    ensemble's MSE, the beta-ELBO with eps from ``noise("update",
    shape)``."""
    from ..models import cvae_loss, hsr_nll
    model, name, epochs = run.model, run.name, run.fc.epochs
    beta = run.cfg.get("model", {}).get("beta", 1.0)

    def loss_fn(xb, yb, ep):
        if name == "hsr":
            return hsr_nll(*model(xb), yb, warm=ep < epochs // 3)
        if name == "rpn":
            return model.loss(xb, yb)
        eps = noise("update", (len(xb), model.latent_dim))
        return cvae_loss(model, yb, xb, eps, beta)
    return loss_fn


def stochastic_epoch(run: Offline, opt, loss_fn, ep: int) -> float:
    """One training epoch of a stochastic arm: an update of ``opt`` for
    each batch of ``flat_batches(..., seed=ep)``. Returns the mean
    loss."""
    from ..data import flat_batches
    from ..train.loop import zero_missing_grads_
    params = [p for g in opt.param_groups for p in g["params"]]
    tot, n = 0.0, 0
    for xb, yb in flat_batches(run.xn[:run.ntr], run.yn[:run.ntr],
                               run.fc.batch_size, seed=ep):
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(xb, yb, ep)
            loss.backward()
        zero_missing_grads_(params)
        opt.step()
        tot = tot + loss.detach().double()
        n += 1
    return float(tot) / max(n, 1)


def train_stochastic(run: Offline, noise_source=None) -> int:
    """The HSR, RPN and cVAE arms: their own losses, plain Adam, one
    record an epoch, then the scoreboard with CRPS of the validation
    block. ``noise_source(what, shape)`` gives every draw (default
    ``SeededNoise`` from ``seed`` on the run's device)."""
    from ..metrics import evaluate
    from ..models import cvae_samples, hsr_sample

    cfg, model, name = run.cfg, run.model, run.name
    noise = noise_source or SeededNoise(cfg.get("seed", 0), run.xn.device)
    opt = torch.optim.Adam(model.parameters(), lr=run.fc.lr)  # optax's
    loss_fn = stochastic_loss(run, noise)
    for ep in range(run.fc.epochs):
        t0 = time.time()
        rec = {"epoch": ep,
               "train_loss": stochastic_epoch(run, opt, loss_fn, ep)}
        print(json.dumps(rec))
        run.history.append(dict(rec, seconds=time.time() - t0))

    rows = validation_rows(run)
    if rows is not None:
        lo, hi, T = rows
        xv, ny = run.xn[lo:hi], run.yn.shape[1]
        S = cfg.get("num_crps_samples", 16)
        with torch.no_grad():
            if name == "hsr":
                sp = hsr_sample(model, xv, S, noise=noise(
                    "sample_eps", (hi - lo, ny, S)))
            elif name == "rpn":
                sp = model.samples(xv)
            else:
                sp = cvae_samples(model, xv, S, noise=(
                    noise("sample_z", (S, hi - lo, model.latent_dim)),
                    noise("sample_eps", (S, hi - lo, ny))))
        run.scores = evaluate(sp.mean(-1).reshape(T, NCOL, ny),
                              run.yn[lo:hi].reshape(T, NCOL, ny),
                              run.x[lo:hi, run.vset.ps_index].reshape(T, NCOL),
                              run.vset, run.grid, scale=run.nz.scale,
                              samplepreds=sp.reshape(T, NCOL, ny, -1))
        print(run.scores.round(4).to_string())
    return 0


def load_classifier(run: Offline, path: str) -> None:
    """``init_from``: the tensors of a classifier checkpoint (the file, or
    the directory holding ``classifier.pt``) whose names and shapes match,
    loaded into the run's model."""
    from ..train.finetune import partial_load
    if os.path.isdir(path):
        path = os.path.join(path, CLASSIFIER_FILE)
    dev = next(run.model.parameters()).device
    ck = torch.load(path, map_location=dev, weights_only=True)
    nl, ns = partial_load(run.model, ck.get("params", ck))
    print(f"init_from: loaded {nl} tensors, kept {ns}")


def classifier_ce(run: Offline, i: int):
    """The classifier's mean cross-entropy on the batch of rows i .. i +
    batch_size - 1."""
    from ..models import classifier_loss
    j = i + run.fc.batch_size
    return classifier_loss(run.model(run.xn[i:j]), run.labels[i:j])


def classifier_epoch(run: Offline, opt, gradout: bool = False):
    """One training epoch of the classifier: an update of ``opt`` after
    global-norm clipping at ``max_grad_norm`` for each unshuffled batch of
    the training rows. Returns the mean train_ce and, for ``gradout``,
    the gradients' statistics (the largest |g| of the epoch, and the
    means over its updates of the mean per-tensor L2 norm and of the
    global norm; every parameter counts, those with a zero gradient too,
    as in JAX)."""
    from ..train.loop import clip_by_global_norm_, zero_missing_grads_
    params = [p for g in opt.param_groups for p in g["params"]]
    bs, max_norm = run.fc.batch_size, run.fc.max_grad_norm
    tot, n, stats = 0.0, 0, []
    for i in range(0, run.ntr - bs + 1, bs):
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = classifier_ce(run, i)
            loss.backward()
        grads = zero_missing_grads_(params)
        if gradout:
            l2 = torch.stack(torch._foreach_norm(grads))
            top = torch.stack(torch._foreach_norm(grads, float("inf")))
            stats.append(torch.stack([top.max(), l2.mean(),
                                      torch.linalg.vector_norm(l2)]))
        if max_norm:
            clip_by_global_norm_(grads, max_norm)
        opt.step()
        tot = tot + loss.detach().double()
        n += 1
    out = {}
    if gradout and n:
        st = torch.stack(stats).double()
        out = dict(max_grad=float(st[:, 0].max()),
                   mean_grad_l2=float(st[:, 1].sum()) / n,
                   total_norm=float(st[:, 2].sum()) / n)
    return float(tot) / max(n, 1), out


def train_classifier(run: Offline, gradout: bool = False) -> int:
    """The cloud-state classifier U-Net and its gradout variant: Adam
    after global-norm clipping, unshuffled batches, one record an epoch
    (``classifier_epoch``, then the validation's mean cross-entropy, with
    the gradients' statistics for ``gradout``), the checkpoint, then the
    per-class accuracy of the validation block's first 4 batches."""
    cfg, model, bs = run.cfg, run.model, run.fc.batch_size
    if cfg.get("init_from"):
        load_classifier(run, cfg["init_from"])
    opt = torch.optim.Adam(model.parameters(), lr=run.fc.lr)  # optax's
    for ep in range(run.fc.epochs):
        t0 = time.time()
        train_ce, stats = classifier_epoch(run, opt, gradout)
        vtot, vn = 0.0, 0
        with torch.no_grad():
            for i in range(run.ntr, len(run.xn) - bs + 1, bs):
                vtot = vtot + classifier_ce(run, i).double()
                vn += 1
        rec = {"epoch": ep, "train_ce": train_ce,
               "val_ce": float(vtot) / max(vn, 1), **stats}
        print(json.dumps(rec))
        run.history.append(dict(rec, seconds=time.time() - t0))

    if cfg.get("checkpoint_dir"):
        os.makedirs(cfg["checkpoint_dir"], exist_ok=True)
        torch.save({"params": model.state_dict()},
                   os.path.join(cfg["checkpoint_dir"], CLASSIFIER_FILE))
    xn, labels = run.xn, run.labels
    nval = min(len(xn) - run.ntr, 4 * bs)
    if nval > 0:
        with torch.no_grad():
            pred = torch.argmax(model(xn[run.ntr:run.ntr + nval]), dim=2)
        lab = labels[run.ntr:run.ntr + nval]
        hit = (pred == lab).double()
        per = {int(c): float(hit[lab == c].mean())
               for c in torch.unique(lab).tolist()}
        print(json.dumps({"val_accuracy": float(hit.mean()),
                          "per_class": per}))
    return 0


def main(argv=None, noise_source=None):
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); the stochastic
    arms draw from ``noise_source`` (see ``train_stochastic``)."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    from ..metrics import evaluate
    from ..train import fit
    from ..train.config import load_config

    cfg = load_config(argv[0], argv[1:])
    run = setup(cfg)
    if run.name in STOCHASTIC:
        return train_stochastic(run, noise_source)
    if run.name in CLASSIFIERS:
        return train_classifier(run, gradout=run.name == "classifier_gradout")
    rng = np.random.default_rng(int(cfg.get("seed", 0)))
    _, run.history = fit(run.model, run.vset, run.fc,
                         lambda: run.train_batches(rng), run.val_batches,
                         checkpoint_dir=cfg.get("checkpoint_dir"))
    for rec in run.history:
        print(json.dumps(rec))
    block = validation_block(run)
    if block is not None:
        run.scores = evaluate(*block, run.vset, run.grid, scale=run.nz.scale)
        if cfg.get("metrics_csv"):
            run.scores.to_csv(cfg["metrics_csv"])
        print(run.scores.round(4).to_string())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
