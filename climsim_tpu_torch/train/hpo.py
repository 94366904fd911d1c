"""Hyperparameter search: random search over config spaces
(counterpart of ``climsim_tpu/train/hpo.py``; host numpy, copied as it
is).

Replaces the reference's KerasTuner RandomSearch + Slurm chief/worker
oracle (baseline_models/MLP/training/HPO/baseline_v1/hpo_baseline_v1.py:
17-43, 227-260) with a functional in-process searcher: sample configs from
a declarative space, run a user-supplied trial function, retain the top-K.
Parallelism comes from the mesh (vmap/pjit inside the trial), not from a
TCP oracle; multi-host sweeps shard trial seeds by process index.

A batched trial of :func:`parallel_random_search` runs ``torch.func.vmap``
over plain torch operations only: the port's kernel wrappers (``ctypes``
launches inside ``autograd.Function``s) have no vmap rule, where JAX
batches ``pallas_call``. A model that runs the kernels goes through
:func:`random_search`, one trial at a time.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


@dataclass
class SearchSpace:
    """Declarative space: name -> ('choice', [..]) | ('loguniform', lo, hi)
    | ('uniform', lo, hi) | ('int', lo, hi)."""

    params: dict = field(default_factory=dict)

    def sample(self, rng: np.random.Generator) -> dict:
        out = {}
        for name, spec in self.params.items():
            kind = spec[0]
            if kind == "choice":
                out[name] = spec[1][rng.integers(len(spec[1]))]
            elif kind == "loguniform":
                out[name] = float(np.exp(rng.uniform(np.log(spec[1]),
                                                     np.log(spec[2]))))
            elif kind == "uniform":
                out[name] = float(rng.uniform(spec[1], spec[2]))
            elif kind == "int":
                out[name] = int(rng.integers(spec[1], spec[2] + 1))
            else:
                raise ValueError(f"unknown spec {spec}")
        return out


def random_search(trial_fn: Callable[[dict], float], space: SearchSpace,
                  num_trials: int = 20, seed: int = 0, top_k: int = 5,
                  max_retries: int = 1, log_path: str | None = None,
                  minimize: bool = True, worker_id: int = 0,
                  num_workers: int = 1) -> list[dict]:
    """Run trials; returns top-K [{'config', 'score', 'seconds'}] sorted
    best-first. A trial raising is retried up to ``max_retries`` then
    recorded as inf (KerasTuner max_retries_per_trial=1 semantics).

    Multi-worker sweeps (the chief/worker-oracle replacement): give each
    process the same ``seed``/``num_trials`` plus its ``worker_id`` — the
    trial stream is deterministic, workers take disjoint trials by index,
    and ``merge_results`` combines their JSONL logs chief-side."""
    results = []
    for i in range(num_trials):
        # per-trial rng keyed on (seed, i): identical across workers, so
        # striding by worker never changes which config trial i draws
        cfg = space.sample(np.random.default_rng((seed, i)))
        if i % num_workers != worker_id:
            continue
        score, t0 = np.inf, time.time()
        for attempt in range(max_retries + 1):
            try:
                score = float(trial_fn(cfg))
                break
            except Exception as e:   # noqa: BLE001 — trial isolation
                if attempt == max_retries:
                    score = np.inf
        rec = {"trial": i, "config": cfg, "score": score,
               "seconds": time.time() - t0}
        results.append(rec)
        if log_path:
            with open(log_path, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")
    key = (lambda r: r["score"]) if minimize else (lambda r: -r["score"])
    finite = [r for r in results if np.isfinite(r["score"])]
    return sorted(finite, key=key)[:top_k]


def parallel_random_search(batched_trial_fn: Callable[[dict, dict], Any],
                           space: SearchSpace, num_trials: int = 20,
                           batch_size: int = 8, seed: int = 0,
                           top_k: int = 5, log_path: str | None = None,
                           minimize: bool = True,
                           max_retries: int = 1) -> list[dict]:
    """Device-parallel random search: run many trials per accelerator pass.

    The reference's chief/worker oracle parallelized trials across Slurm
    jobs; on one card the equivalent is to vmap the whole training loop
    over the CONTINUOUS hyperparameters (lr, weight decay, noise
    scales...) so B small models train simultaneously: the card sees a
    B-times-larger batched matmul instead of B sequential tiny ones.

    Shape-affecting fields ('choice' and 'int' specs: widths, depths,
    cell types) fix the tensors' shapes, so sampled configs are grouped by
    their static-field combination and each group runs in vmapped batches
    of ``batch_size``.

    ``batched_trial_fn(static_cfg: dict, vec_cfg: dict[str, np.ndarray])``
    receives one group's static config plus arrays of length b for every
    continuous field, and returns b scores (typically: build the model
    from ``static_cfg`` once, then ``torch.func.vmap`` the per-config
    train function over ``vec_cfg``; plain torch operations only, see the
    module's docstring). Returns the global top-K records like
    :func:`random_search`.
    """
    samples = [space.sample(np.random.default_rng((seed, i)))
               for i in range(num_trials)]
    static_keys = sorted(k for k, spec in space.params.items()
                         if spec[0] in ("choice", "int"))
    vec_keys = sorted(k for k, spec in space.params.items()
                      if spec[0] in ("uniform", "loguniform"))
    groups: dict = {}
    for i, cfg in enumerate(samples):
        gkey = tuple((k, cfg[k]) for k in static_keys)
        groups.setdefault(gkey, []).append(i)

    results = []
    for gkey, idxs in groups.items():
        static_cfg = dict(gkey)
        for lo in range(0, len(idxs), batch_size):
            batch = idxs[lo:lo + batch_size]
            vec_cfg = {k: np.asarray([samples[i][k] for i in batch])
                       for k in vec_keys}
            t0 = time.time()
            scores = None
            for attempt in range(max_retries + 1):
                try:
                    scores = np.asarray(batched_trial_fn(static_cfg,
                                                         vec_cfg),
                                        np.float64).reshape(-1)
                    break
                except Exception:     # noqa: BLE001 — trial isolation
                    if attempt == max_retries:
                        scores = np.full(len(batch), np.inf)
            dt_batch = time.time() - t0
            for j, i in enumerate(batch):
                rec = {"trial": i, "config": samples[i],
                       "score": float(scores[j]),
                       "seconds": dt_batch / len(batch)}
                results.append(rec)
                if log_path:
                    with open(log_path, "a") as f:
                        f.write(json.dumps(rec, default=str) + "\n")
    key = (lambda r: r["score"]) if minimize else (lambda r: -r["score"])
    finite = [r for r in results if np.isfinite(r["score"])]
    return sorted(finite, key=key)[:top_k]


def merge_results(log_paths, top_k: int = 5,
                  minimize: bool = True) -> list[dict]:
    """Chief-side merge of per-worker JSONL trial logs -> global top-K."""
    results = []
    for p in log_paths:
        with open(p) as f:
            for line in f:
                if line.strip():
                    results.append(json.loads(line))
    key = (lambda r: r["score"]) if minimize else (lambda r: -r["score"])
    finite = [r for r in results if np.isfinite(r["score"])]
    return sorted(finite, key=key)[:top_k]
