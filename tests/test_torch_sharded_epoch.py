"""The port's data-parallel rollout epoch (``train/rollout.py::
run_epoch_fused(mesh=)``) on 2 and 4 gloo ranks on the CPU, with the dry
run's scan-arm emulator (nneur 16, nh_mem 4) on JAX's initial weights and
two chunks of 4 steps of 16 columns at 20 levels, W 2 (4 updates):

* against the port's single-device epoch on the same weights and data,
  within rtol 1e-5 (the record's loss, every parameter with an absolute
  floor of 1e-6, and the memory, each rank's block of it): the ranks'
  mean gradient sums the columns in another order;
* against JAX's sharded ``run_epoch_fused`` on a virtual mesh of the same
  size, within rtol 3e-4 and atol 1e-6 (tests/test_rnn.py:494-496's
  tolerances for JAX's own sharded epoch against its single-device one),
  the loss within rtol 1e-4;
* with ``w_bias > 0`` (and the GEL and accumulated-precipitation terms,
  with remat): the bias penalty's batch means and the GEL exponent's mean
  are reduced over every rank (``GlobalBatch``), so the sharded epoch
  still equals the single-device one and JAX's global-loss epoch;
* with mixed replay (the mask drawn over the global batch and sliced;
  torch's generator is not JAX's, so against the port's single-device
  epoch only);
* a batch that does not divide over the ranks raises ValueError;

and ``python -m climsim_tpu_torch.cli.dryrun_multichip --devices 2
--device cpu`` prints its three OK lines."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.data import keeplev_chunks as jax_chunks
from climsim_tpu.models.rnn import RNNAutoreg as JaxRNNAutoreg
from climsim_tpu.parallel import make_mesh as jax_make_mesh
from climsim_tpu.train.rollout import (RolloutConfig as JaxConfig,
                                       RolloutTrainer as JaxTrainer,
                                       run_epoch_fused as jax_run_epoch_fused)

import torch_dist_workers as W

RANKS = (2, 4)
JAX_CASES = ("base", "bias")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_params():
    model = JaxRNNAutoreg(**W.EMULATOR)
    with jax.enable_x64(False):
        params = model.init(jax.random.PRNGKey(3),
                            jnp.ones((4, W.EPOCH_L, 6), jnp.float32),
                            jnp.ones((4, 24), jnp.float32),
                            jnp.zeros((4, W.EPOCH_L, 4), jnp.float32))
    return model, params


def jax_epoch(model, params, case, n):
    """JAX's fused epoch of ``case`` sharded over an n-device mesh:
    (record, flat parameters)."""
    data = W.epoch_data()
    with jax.enable_x64(False):
        tr = JaxTrainer(model, JaxConfig(**W.EPOCH_CASES[case]),
                        *W.epoch_hybrid(), yscale_lev=jnp.ones((1, 1, 6)),
                        yscale_sca=jnp.ones(8))
        chunks = lambda: jax_chunks(data["x_lev"], data["x_sfc"],
                                    data["y_lev"], data["y_sfc"], data["sp"],
                                    chunk_size=4, shuffle=False)
        _, opt, mem = tr.init(jax.random.PRNGKey(0), next(iter(chunks())))
        p, _, _, rec = jax_run_epoch_fused(tr, params, opt, mem, chunks(), 0,
                                           mesh=jax_make_mesh(n,
                                                              axis="data"))
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(p["params"], "")
    return rec, flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    model, params = jax_params()
    tree = jax.tree_util.tree_map(np.asarray, params)
    dirs = {n: tmp_path_factory.mktemp(f"epoch{n}") for n in RANKS}
    ctxs = [W.spawn(W.sharded_epoch_ranks, n, dirs[n], tree) for n in RANKS]
    single = {case: W.run_epoch(tree, case) for case in W.EPOCH_CASES}
    jax_out = {(case, n): jax_epoch(model, params, case, n)
               for case in JAX_CASES for n in RANKS}
    for ctx in ctxs:
        W.join(ctx)
    port = {n: {case: W.load(dirs[n], case, n)
                for case in list(W.EPOCH_CASES) + ["errors"]}
            for n in RANKS}
    return single, port, jax_out


def close(got, want, rtol, atol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=err_msg)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("case", list(W.EPOCH_CASES))
def test_sharded_epoch_matches_single_device(runs, case, ranks):
    single, port, _ = runs
    rec1, params1, mem1 = single[case]
    parts = port[ranks][case]
    for r in parts:
        rec = r["rec"]
        for k in ("epoch", "window", "mix_frac", "updates", "dispatches"):
            assert rec[k] == rec1[k], k
        assert rec["updates"] == 4
        close(rec["loss"], rec1["loss"], 1e-5, err_msg="loss")
        # the parameters stay equal on every rank
        for k, v in r["params"].items():
            assert torch.equal(v, parts[0]["params"][k]), k
    init = W.epoch_trainer(jax.tree_util.tree_map(
        np.asarray, jax_params()[1]), case).model.state_dict()
    for k, v in parts[0]["params"].items():
        close(v.numpy(), params1[k].numpy(), 1e-5, 1e-6, err_msg=k)
        assert not torch.equal(v, init[k]), f"{k} did not move"
    mem = torch.cat([r["mem"] for r in parts])
    close(mem.numpy(), mem1.numpy(), 1e-5, 1e-6, err_msg="memory")


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("case", JAX_CASES)
def test_sharded_epoch_matches_jax_sharded(runs, case, ranks):
    _, port, jax_out = runs
    jrec, jflat = jax_out[(case, ranks)]
    rec = port[ranks][case][0]["rec"]
    assert rec["updates"] == jrec["updates"] == 4
    close(rec["loss"], jrec["loss"], 1e-4, err_msg="loss")
    for k, v in port[ranks][case][0]["params"].items():
        close(v.numpy(), jflat[k], 3e-4, 1e-6, err_msg=k)


@pytest.mark.parametrize("ranks", RANKS)
def test_undivided_batch_raises(runs, ranks):
    _, port, _ = runs
    for msg in port[ranks]["errors"]:
        assert msg is not None and "do not divide" in msg


def test_dryrun_multichip_two_ranks(tmp_path):
    """The dry-run CLI as a user runs it, from a directory holding a grid
    file at its default place."""
    from test_torch_train_cli import write_grid
    os.makedirs(tmp_path / "grid_info")
    write_grid(str(tmp_path / "grid_info" / "ClimSim_low-res_grid-info.nc"),
               384)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-m",
                          "climsim_tpu_torch.cli.dryrun_multichip",
                          "--devices", "2", "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("dryrun_multichip(2)")]
    assert len(lines) == 3 and all(ln.endswith("OK") for ln in lines)
    assert "dp train loss=" in lines[0]
    assert "== single-device OK" in lines[1]
    assert "dp rollout train loss=" in lines[2]
