"""Offline baseline trainer CLI (counterpart of
``climsim_tpu/cli/train_offline.py``): one YAML config and dotted
overrides train the MLP, CNN or ED baseline on the flat contract and
print one JSON record an epoch and the weighted scoreboard of the
validation block.

Usage:
    python -m climsim_tpu_torch.cli.train_offline conf/mlp_v1.yaml \\
        [model.name=cnn optimizer.lr=3e-4 data.steps=100 device=cpu ...]

It reads the same yamls and overrides as the JAX CLI and builds the same
data, normalization, model and loop, with these differences:

* ``device`` (default ``cuda``) says where it runs; without a card it
  raises unless given ``device=cpu``; JAX's ``platform=cpu`` is taken as
  ``device=cpu``.
* The synthetic series is made on the card (``data/synthetic.py::
  make_timeseries`` from ``data.seed``), normalized there and kept
  there: each batch is cut on the card from the same
  ``default_rng(seed)`` permutation as ``data/loader.py::flat_batches``
  draws, so no batch is copied from the host.
* JAX draws each epoch's shuffle seed from numpy's global, unseeded
  generator; here it comes from ``np.random.default_rng(seed)``, so a run
  repeats.
* ``grid_path`` defaults to ``cli.run_hybrid.DEFAULT_GRID``, relative to
  the working directory.
* Initial weights come from ``seed`` through the model's constructor;
  checkpoints (``checkpoint_dir``) are torch files.
* The CNN trains without dropout, as JAX's ``fit`` calls it
  (deterministic).
* ``model.name`` unet, classifier and classifier_gradout (ROADMAP A.13,
  the rest), hsr, rpn and cvae (A.13, the stochastic stack) and
  ``optimizer.name`` soap or muon (A.13, the optimizers) raise
  ``NotImplementedError`` before any data is built.
"""
from __future__ import annotations

import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

UNPORTED_MODELS = {"unet": "A.13, the rest", "classifier": "A.13, the rest",
                   "classifier_gradout": "A.13, the rest",
                   "hsr": "A.13, the stochastic stack",
                   "rpn": "A.13, the stochastic stack",
                   "cvae": "A.13, the stochastic stack"}
# rows of the time-major flat arrays per step (the low-res grid's columns)
NCOL = 384


def check_unported(cfg) -> None:
    """Raise for the models and optimizers this port does not run yet,
    before any data is built."""
    name = cfg.get("model", {}).get("name", "mlp")
    if name in UNPORTED_MODELS:
        raise NotImplementedError(
            f"train_offline: model.name {name!r} is not ported yet (ROADMAP "
            f"{UNPORTED_MODELS[name]})")
    opt = cfg.get("optimizer", {}).get("name", "adam")
    if opt in ("soap", "muon"):
        raise NotImplementedError(
            f"train_offline: optimizer.name {opt!r} is not ported yet "
            f"(ROADMAP A.13, the optimizers)")


def build_model(name: str, vset, mcfg, device, seed: int = 0):
    """The model of ``model.name`` (mlp | cnn | ed) with the yaml's
    options, its weights from ``seed``."""
    from .. import models as M
    policy = M.BF16 if mcfg.get("bf16", False) else M.F32
    if name == "mlp":
        return M.mlp_for(vset, features=tuple(mcfg.get(
            "features", (768, 640, 512, 640, 640))), policy=policy,
            device=device, seed=seed)
    if name == "cnn":
        return M.CNN(depth=mcfg.get("depth", 12),
                     channels=mcfg.get("channels", 406), policy=policy,
                     device=device, seed=seed)
    if name == "ed":
        return M.ED(vset.input_feature_len, vset.target_feature_len,
                    latent_dim=mcfg.get("latent_dim", 5),
                    intermediate_dim=mcfg.get("intermediate_dim", 463),
                    policy=policy, device=device, seed=seed)
    raise ValueError(f"unknown offline model {name}")


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
    (for ps), the normalized xn, yn on the device, the normalizer, the
    first validation row ``ntr``, the model, its FitConfig, and the grid
    and variable set."""
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

    check_unported(cfg)
    device = cli_device(cfg)
    vset = V.get(cfg.get("vset", "v1"))
    grid = Grid.from_file(cfg.get("grid_path", DEFAULT_GRID), device=device)
    dcfg = cfg.get("data", {})
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
    name = cfg.get("model", {}).get("name", "mlp")
    model = build_model(name, vset, cfg.get("model", {}), device,
                        seed=int(cfg.get("seed", 0)))
    return Offline(cfg, x, xn, yn, nz, ntr, model, fit_config(cfg), grid,
                   vset)


def validation_block(run: Offline):
    """(pred, target, ps_raw) of the validation block's whole steps,
    [T, NCOL, ny], [T, NCOL, ny] and [T, NCOL], or None when it holds
    none."""
    nval = (len(run.xn) - run.ntr) // NCOL * NCOL
    if nval <= 0:
        return None
    lo, hi, T = run.ntr, run.ntr + nval, nval // NCOL
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


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    from ..metrics import evaluate
    from ..train import fit
    from ..train.config import load_config

    cfg = load_config(argv[0], argv[1:])
    run = setup(cfg)
    rng = np.random.default_rng(int(cfg.get("seed", 0)))
    _, hist = fit(run.model, run.vset, run.fc,
                  lambda: run.train_batches(rng), run.val_batches,
                  checkpoint_dir=cfg.get("checkpoint_dir"))
    for rec in hist:
        print(json.dumps(rec))
    block = validation_block(run)
    if block is not None:
        df = evaluate(*block, run.vset, run.grid, scale=run.nz.scale)
        if cfg.get("metrics_csv"):
            df.to_csv(cfg["metrics_csv"])
        print(df.round(4).to_string())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
