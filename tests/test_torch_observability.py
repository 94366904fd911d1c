"""The port's observability hooks (``utils/observability.py``) and the
profiling CLI (``cli/profile.py``) on the CPU, against the JAX package's
where both count the same thing: ``Throughput`` and ``JsonlLogger`` as
JAX's tests/test_infra.py::test_observability, a trace file written,
and ``flop_analysis`` of a matrix product."""
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.utils.observability import flop_analysis as jax_flops
from climsim_tpu_torch.cli import profile
from climsim_tpu_torch.cli.run_hybrid import DEFAULT_GRID
from climsim_tpu_torch.utils import (JsonlLogger, Throughput, annotate,
                                     device_memory_stats, host_memory_stats,
                                     trace)
from climsim_tpu_torch.utils.observability import (achieved_flops,
                                                   flop_analysis)

from test_torch_train_cli import write_grid


def test_throughput_and_logger(tmp_path):
    tp = Throughput(report_every=2)
    for _ in range(4):
        with tp.step(items=10):
            pass
    rec = tp.report()
    assert rec["steps"] == 4 and rec["items_per_s"] > 0
    assert tp.should_report and 0 <= rec["compute_frac"] <= 1
    lg = JsonlLogger(str(tmp_path / "log.jsonl"))
    lg.log({"loss": 1.0}, step=0)
    lg.log({"loss": np.float32(0.5)}, step=1)
    rows = lg.read()
    assert len(rows) == 2 and rows[1]["loss"] == 0.5 and rows[0]["step"] == 0
    assert JsonlLogger(str(tmp_path / "none.jsonl")).read() == []


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "tb"), device="cpu"):
        with annotate("step_0"):
            (x @ x).sum()
    files = glob.glob(str(tmp_path / "tb" / "trace_*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "step_0" in names and "aten::mm" in names


def test_memory_stats():
    assert "total_gb" in host_memory_stats() or \
        "maxrss_gb" in host_memory_stats()
    recs = device_memory_stats()
    assert len(recs) == torch.cuda.device_count()


@pytest.mark.parametrize("m,k,n", [(64, 32, 16), (256, 256, 256)])
def test_flop_analysis_matmul(m, k, n):
    """2 m n k FLOPs and the operands' and result's bytes, as JAX's cost
    analysis gives for the same product."""
    a, b = torch.ones(m, k), torch.ones(k, n)
    got = flop_analysis(lambda x, y: x @ y, a, b)
    assert got["flops"] == 2 * m * n * k
    assert got["bytes_accessed"] == 4 * (m * k + k * n + m * n)
    want = jax_flops(lambda x, y: x @ y, jnp.ones((m, k), jnp.float32),
                     jnp.ones((k, n), jnp.float32))
    if want:
        assert got["flops"] == want["flops"]
        np.testing.assert_allclose(got["arithmetic_intensity"],
                                   want["arithmetic_intensity"], rtol=1e-6)
    res = achieved_flops(lambda x, y: x @ y, a, b, iters=3, peak_flops=1e12)
    assert res["seconds_per_call"] > 0 and res["achieved_flops_per_s"] > 0
    assert 0 < res["mfu"]
    assert flop_analysis(torch.tanh, a) == {}


def test_profile_cli_runs(tmp_path, monkeypatch, capsys):
    """cli.profile --device cpu --batch 8 --steps 1, from a directory that
    holds the grid file at run_hybrid.DEFAULT_GRID."""
    monkeypatch.chdir(tmp_path)
    os.makedirs(os.path.dirname(DEFAULT_GRID))
    write_grid(DEFAULT_GRID)
    assert profile.main(["--device", "cpu", "--batch", "8", "--steps", "1",
                         "--logdir", "tb"]) == 0
    out = capsys.readouterr().out
    assert "trace written to tb" in out and "flops" in out
    assert len(glob.glob("tb/trace_*.json")) == 1
