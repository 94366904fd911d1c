"""The port's hyperparameter search (``climsim_tpu_torch/train/hpo.py``)
against the JAX package's (``climsim_tpu/train/hpo.py``) on the spaces
and seeds of JAX's own tests (tests/test_infra.py): the same trials,
configs, orders and scores, the JSONL records included (a raising
trial's inf among them); and a batched trial through ``torch.func.vmap``
equal to the same trials run one at a time."""
import json

import numpy as np
import pytest
import torch

from climsim_tpu.train import hpo as jhpo
from climsim_tpu_torch.train import hpo


def records(path):
    """The JSONL records without their wall seconds."""
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k != "seconds"} for line in f if line.strip()]


def strip(top):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in top]


FLAKY_SPACE = {"lr": ("loguniform", 1e-4, 1e-1),
               "width": ("choice", [64, 128]), "depth": ("int", 2, 5)}


def flaky_trial(cfg):
    if cfg["width"] == 64:
        raise RuntimeError("flaky")        # the retry -> inf path
    return abs(np.log10(cfg["lr"]) + 2)


@pytest.mark.parametrize("seed", [0, 5])
def test_space_sample_equal(seed):
    space = {"a": ("uniform", -1.0, 2.0), **FLAKY_SPACE,
             "c": ("choice", ["x", "y", "z"])}
    for i in range(20):
        want = jhpo.SearchSpace(space).sample(np.random.default_rng((seed,
                                                                     i)))
        got = hpo.SearchSpace(space).sample(np.random.default_rng((seed, i)))
        assert got == want and [type(v) for v in got.values()] \
            == [type(v) for v in want.values()]
    with pytest.raises(ValueError):
        hpo.SearchSpace({"x": ("normal", 0, 1)}).sample(
            np.random.default_rng(0))


def test_random_search_equal_with_raising_trial(tmp_path):
    kw = dict(num_trials=30, top_k=3, seed=0)
    want = jhpo.random_search(flaky_trial, jhpo.SearchSpace(FLAKY_SPACE),
                              log_path=str(tmp_path / "j.jsonl"), **kw)
    calls = []

    def counted(cfg):
        calls.append(cfg)
        return flaky_trial(cfg)

    got = hpo.random_search(counted, hpo.SearchSpace(FLAKY_SPACE),
                            log_path=str(tmp_path / "t.jsonl"), **kw)
    assert strip(got) == strip(want)
    assert all(t["config"]["width"] == 128 for t in got)
    logged = records(tmp_path / "t.jsonl")
    assert logged == records(tmp_path / "j.jsonl")
    n_inf = sum(r["score"] == float("inf") for r in logged)
    assert n_inf > 0 and len(logged) == 30
    # each raising trial was tried max_retries + 1 = 2 times
    assert len(calls) == 30 + n_inf


def test_multi_worker_partition_equal(tmp_path):
    space = {"lr": ("loguniform", 1e-4, 1e-1)}
    trial = lambda cfg: abs(np.log10(cfg["lr"]) + 2)
    solo = hpo.random_search(trial, hpo.SearchSpace(space), num_trials=12,
                             top_k=12, seed=7)
    logs = {"j": [], "t": []}
    for w in range(3):
        for tag, mod in (("j", jhpo), ("t", hpo)):
            lp = str(tmp_path / f"{tag}{w}.jsonl")
            logs[tag].append(lp)
            mod.random_search(trial, mod.SearchSpace(space), num_trials=12,
                              top_k=12, seed=7, worker_id=w, num_workers=3,
                              log_path=lp)
        assert records(logs["t"][-1]) == records(logs["j"][-1])
        assert [r["trial"] for r in records(logs["t"][-1])] \
            == list(range(w, 12, 3))
    merged = hpo.merge_results(logs["t"], top_k=12)
    assert strip(merged) == strip(jhpo.merge_results(logs["j"], top_k=12))
    assert [r["trial"] for r in merged] == [r["trial"] for r in solo]
    for a, b in zip(solo, merged):
        assert abs(a["score"] - b["score"]) < 1e-12
    assert strip(hpo.merge_results(logs["t"], top_k=4, minimize=False)) \
        == strip(jhpo.merge_results(logs["j"], top_k=4, minimize=False))


VEC_SPACE = {"lr": ("loguniform", 1e-3, 1.0), "width": ("choice", [4, 8])}


def regression(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    w = rng.normal(size=(4,)).astype(np.float32)
    return torch.as_tensor(X), torch.as_tensor(X @ w)


def train_one(X, y, lr, steps=50):
    """Gradient descent on the least-squares fit: the trial of JAX's
    test_hpo_parallel_vmapped_trials, in plain torch operations."""
    w = torch.zeros(4, dtype=X.dtype)
    for _ in range(steps):
        w = w - lr * (X.T @ (X @ w - y) / X.shape[0])
    return torch.mean((X @ w - y) ** 2)


def test_parallel_search_vmap_equals_sequential(tmp_path):
    X, y = regression()
    calls = []

    def batched(static_cfg, vec_cfg):
        calls.append((static_cfg["width"], len(vec_cfg["lr"])))
        lrs = torch.as_tensor(vec_cfg["lr"], dtype=torch.float32)
        return torch.func.vmap(lambda lr: train_one(X, y, lr))(lrs).numpy()

    top = hpo.parallel_random_search(batched, hpo.SearchSpace(VEC_SPACE),
                                     num_trials=16, batch_size=8, top_k=16,
                                     seed=3, log_path=str(tmp_path / "p"))
    assert len(calls) < 16 and sum(n for _, n in calls) == 16
    assert top[0]["score"] < 1e-2
    scores = [t["score"] for t in top]
    assert scores == sorted(scores)
    seq = hpo.random_search(
        lambda cfg: float(train_one(X, y, torch.tensor(cfg["lr"],
                                                       dtype=torch.float32))),
        hpo.SearchSpace(VEC_SPACE), num_trials=16, top_k=16, seed=3)
    by_trial = {r["trial"]: r for r in seq}
    # a batched and an unbatched product round differently: 1e-4 relative,
    # with a floor of 1e-6 of the starting loss for the converged fits,
    # whose loss is float32 rounding residue of the data's scale
    floor = 1e-6 * float(torch.mean(y ** 2))
    for r in top:
        want = by_trial[r["trial"]]
        assert r["config"] == want["config"]
        assert abs(r["score"] - want["score"]) <= 1e-4 * abs(want["score"]) \
            + floor, r
    # the same groups, batches, configs and order as JAX's search
    port_calls, jcalls = list(calls), []

    def jbatched(static_cfg, vec_cfg):
        jcalls.append((static_cfg["width"], len(vec_cfg["lr"])))
        return batched(static_cfg, vec_cfg)

    jtop = jhpo.parallel_random_search(jbatched,
                                       jhpo.SearchSpace(VEC_SPACE),
                                       num_trials=16, batch_size=8,
                                       top_k=16, seed=3,
                                       log_path=str(tmp_path / "j"))
    assert jcalls == port_calls
    assert strip(top) == strip(jtop)
    assert records(tmp_path / "p") == records(tmp_path / "j")
    # and JAX's own vmapped trial (tests/test_infra.py) scores alike
    jax_top = jhpo.parallel_random_search(
        jax_regression_trial(X.numpy(), y.numpy()),
        jhpo.SearchSpace(VEC_SPACE), num_trials=16, batch_size=8, top_k=16,
        seed=3)
    assert [r["trial"] for r in jax_top] == [r["trial"] for r in top]
    for r, want in zip(top, jax_top):
        assert abs(r["score"] - want["score"]) <= 1e-4 * abs(want["score"]) \
            + floor, (r, want)


def jax_regression_trial(X, y):
    import jax
    import jax.numpy as jnp

    def batched(static_cfg, vec_cfg):
        with jax.enable_x64(False):
            Xj, yj = jnp.asarray(X), jnp.asarray(y)

            def one(lr):
                def step(w, _):
                    g = Xj.T @ (Xj @ w - yj) / Xj.shape[0]
                    return w - lr * g, ()
                w, _ = jax.lax.scan(step, jnp.zeros(4, jnp.float32), None,
                                    length=50)
                return jnp.mean((Xj @ w - yj) ** 2)

            return np.asarray(jax.vmap(one)(
                jnp.asarray(vec_cfg["lr"], jnp.float32)))
    return batched


def cfc_trainer(static_cfg, x, y, steps=3):
    """The trial of a CfC of static_cfg's width, built once: a function of
    the learning rate that trains it by ``steps`` SGD steps through
    torch.func and returns its loss."""
    from climsim_tpu_torch.models.ncp import CfC
    model = CfC(x.shape[-1], static_cfg["units"], proj_size=y.shape[-1],
                mixed_memory=True, backbone_units=8, device="cpu", seed=0)
    params0 = {k: v.detach() for k, v in model.named_parameters()}

    def loss(p):
        out, _ = torch.func.functional_call(model, (p,), (x,))
        return torch.mean((out - y) ** 2)

    def train(lr):
        params = params0
        for _ in range(steps):
            g = torch.func.grad(loss)(params)
            params = {k: params[k] - lr * g[k] for k in params}
        return loss(params)
    return train


def test_parallel_search_vmapped_cfc():
    """CfC trials batched by torch.func.vmap over the learning rate score
    as the same trials run one at a time, in the same groups."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(0, 1, (6, 5, 3)).astype(np.float32))
    y = torch.cumsum(x[..., :2], dim=1)
    space = {"lr": ("loguniform", 1e-3, 1e-1), "units": ("choice", [4, 6])}
    passes = []

    def batched(static_cfg, vec_cfg):
        passes.append(len(vec_cfg["lr"]))
        lrs = torch.as_tensor(vec_cfg["lr"], dtype=torch.float32)
        return torch.func.vmap(cfc_trainer(static_cfg, x, y))(lrs) \
            .detach().numpy()

    top = hpo.parallel_random_search(batched, hpo.SearchSpace(space),
                                     num_trials=8, batch_size=3, top_k=8,
                                     seed=2)
    groups = {}
    for i in range(8):
        u = hpo.SearchSpace(space).sample(np.random.default_rng((2, i)))
        groups[u["units"]] = groups.get(u["units"], 0) + 1
    assert len(passes) == sum(-(-n // 3) for n in groups.values())
    seq = hpo.random_search(
        lambda cfg: float(cfc_trainer(cfg, x, y)(torch.tensor(
            cfg["lr"], dtype=torch.float32))),
        hpo.SearchSpace(space), num_trials=8, top_k=8, seed=2)
    assert [r["trial"] for r in top] == [r["trial"] for r in seq]
    for r, want in zip(top, seq):
        assert r["config"] == want["config"]
        assert abs(r["score"] - want["score"]) <= 1e-4 * abs(want["score"])


def test_parallel_search_failing_batch_is_inf(tmp_path):
    def batched(static_cfg, vec_cfg):
        if static_cfg["width"] == 4:
            raise RuntimeError("batch failed")
        return np.asarray(vec_cfg["lr"])

    kw = dict(num_trials=12, batch_size=4, top_k=12, seed=1)
    got = hpo.parallel_random_search(batched, hpo.SearchSpace(VEC_SPACE),
                                     log_path=str(tmp_path / "t"), **kw)
    want = jhpo.parallel_random_search(batched, jhpo.SearchSpace(VEC_SPACE),
                                       log_path=str(tmp_path / "j"), **kw)
    assert strip(got) == strip(want)
    logged = records(tmp_path / "t")
    assert logged == records(tmp_path / "j")
    assert all(r["score"] == float("inf") for r in logged
               if r["config"]["width"] == 4)
    assert all(r["config"]["width"] == 8 for r in got)
