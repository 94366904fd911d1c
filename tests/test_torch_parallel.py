"""The port's ``parallel`` package on gloo ranks on the CPU: the halo
exchange on 4 ranks (width 1 and 2, periodic and not, blocking and
started) against the global stencil, as tests/test_online.py:218-262 holds
JAX's; the sum over ranks, shard_batch, replicate and the meshes' names;
and ``data_parallel_step`` on 2 ranks against JAX's ``data_parallel_step``
on a 2-device mesh (a flax Dense under Adam, the same weights and batch).
The ranks run in spawned processes (``torch_dist_workers``), once per rank
count for the whole file."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from climsim_tpu.parallel import data_parallel_step as jax_dp_step
from climsim_tpu.parallel import make_mesh as jax_make_mesh

import torch_dist_workers as W

HALO_RANKS, DP_RANKS, DP_STEPS, DP_LR = 4, 2, 2, 1e-2


def _jax_data_parallel():
    """JAX's data-parallel Dense + Adam: the initial weights, the batch and,
    after each of DP_STEPS steps, the loss; the final weights."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (8, 5)).astype(np.float32)
    y = rng.normal(0, 1, (8, 3)).astype(np.float32)
    dense = nn.Dense(3)
    params = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))
    init = jax.tree_util.tree_map(np.asarray, params["params"])
    tx = optax.adam(DP_LR)

    def step_fn(state, xb, yb):
        p, opt = state
        loss, g = jax.value_and_grad(
            lambda pp: jnp.mean((dense.apply(pp, xb) - yb) ** 2))(p)
        upd, opt = tx.update(g, opt, p)
        return (optax.apply_updates(p, upd), opt), loss

    step = jax_dp_step(step_fn, jax_make_mesh(DP_RANKS))
    state = (params, tx.init(params))
    losses = []
    for _ in range(DP_STEPS):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    final = jax.tree_util.tree_map(np.asarray, state[0]["params"])
    return init, x, y, losses, final


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    halo_dir = tmp_path_factory.mktemp("halo")
    dp_dir = tmp_path_factory.mktemp("dp")
    init, x, y, losses, final = _jax_data_parallel()
    ctxs = [W.spawn(W.parallel_ranks, HALO_RANKS, halo_dir),
            W.spawn(W.data_parallel_ranks, DP_RANKS, dp_dir, init["kernel"],
                    init["bias"], x, y, DP_LR, DP_STEPS)]
    for ctx in ctxs:
        W.join(ctx)
    return {"halo": W.load(halo_dir, "parallel", HALO_RANKS),
            "dp": W.load(dp_dir, "data_parallel", DP_RANKS),
            "jax_dp": (losses, final)}


def _padded(x, width, periodic):
    """The global rows with ``width`` ghost rows a side: wrapped, or the
    edge rows repeated."""
    if periodic:
        return np.concatenate([x[-width:], x, x[:width]])
    return np.concatenate([x[:1].repeat(width, 0), x,
                           x[-1:].repeat(width, 0)])


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("started", [False, True])
def test_exchange_halo_matches_global_rows(runs, width, periodic, started):
    """Each rank's extended band is the global grid's rows around it, with
    its neighbours' rows as ghosts (wrapped at the ends when periodic,
    the edge row repeated when not); a started exchange gives the same."""
    x = W.halo_input()
    ext = _padded(x, width, periodic)
    n = W.HALO_ROWS // HALO_RANKS
    key = f"halo_{width}_{periodic}" + ("_async" if started else "")
    for r, res in enumerate(runs["halo"]):
        np.testing.assert_array_equal(res[key].numpy(),
                                      ext[r * n:r * n + n + 2 * width],
                                      err_msg=f"rank {r}")


def test_sharded_stencil_matches_global_stencil(runs):
    """The 3-point stencil on halo-1 bands == on the whole grid with
    clamped edges (tests/test_online.py:218-241)."""
    x = W.halo_input()
    xm = np.concatenate([x[:1], x[:-1]])
    xp = np.concatenate([x[1:], x[-1:]])
    want = 0.25 * xm + 0.5 * x + 0.25 * xp
    got = np.concatenate([r["stencil"].numpy() for r in runs["halo"]])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_global_sum_shard_batch_and_meshes(runs):
    n = W.HALO_ROWS // HALO_RANKS
    for r, res in enumerate(runs["halo"]):
        np.testing.assert_array_equal(res["sum"].numpy(),
                                      [HALO_RANKS * (HALO_RANKS + 1) / 2,
                                       2.0 * HALO_RANKS])
        np.testing.assert_array_equal(res["shard"].numpy(),
                                      W.halo_input()[r * n:(r + 1) * n])
        assert res["names"] == ("col",)
        assert res["axis_rank"] == (r, HALO_RANKS)
        assert res["global_names"] == ("data",)
        names, shape, data, ens = res["mesh_2d"]
        assert names == ("data", "ensemble") and shape == (2, 2)
        assert data == (r // 2, 2) and ens == (r % 2, 2)
        assert "does not divide" in res["shard_error"]
        assert "n_devices" in res["mesh_error"]


def test_replicate_broadcasts_from_the_first_rank(runs):
    """A dict of tensors and a module's parameters, different on every
    rank, hold rank 0's values everywhere after replicate."""
    for res in runs["halo"]:
        w, nested, weight, bias = res["replicated"]
        assert not w.any() and not nested.any()
        assert not weight.any() and not bias.any()


def test_data_parallel_step_matches_jax(runs):
    """Two Adam steps on 2 ranks, each its half of the batch, gradients
    all-reduced to their mean: the global mean loss of each step and the
    weights after both equal JAX's sharded jit on a 2-device mesh."""
    losses, final = runs["jax_dp"]
    for r, res in enumerate(runs["dp"]):
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-6,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res["kernel"].numpy(), final["kernel"],
                                   rtol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["bias"].numpy(), final["bias"],
                                   rtol=1e-6, err_msg=f"rank {r}")
    a, b = runs["dp"]
    assert torch.equal(a["kernel"], b["kernel"])
