"""The port's scaling benchmark (``climsim_tpu_torch/cli/scale_bench.py``)
on the CPU: at 1 and 2 gloo ranks on an 8 x 16 grid it prints one JSON line
per device count with the keys of the JAX package's CLI
(``climsim_tpu/cli/scale_bench.py:101-102``), reading the hybrid
coefficients from a grid file at its default place."""
import contextlib
import io
import json

import pytest
import torch
from scipy.io import netcdf_file

from climsim_tpu_torch import Grid
from climsim_tpu_torch.cli import scale_bench
from climsim_tpu_torch.cli.run_hybrid import DEFAULT_GRID

NCOL, NLEV = 384, 60


@pytest.fixture
def grid_dir(tmp_path, monkeypatch):
    """A working directory holding Grid.synthetic(384)'s arrays as a CDF-1
    grid file at ``run_hybrid.DEFAULT_GRID``."""
    path = tmp_path / DEFAULT_GRID
    path.parent.mkdir(parents=True)
    g = Grid.synthetic(NCOL, NLEV, dtype=torch.float64)
    with netcdf_file(str(path), "w") as f:
        f.createDimension("ncol", NCOL)
        f.createDimension("lev", NLEV)
        f.createDimension("ilev", NLEV + 1)
        for k, d in (("lat", "ncol"), ("lon", "ncol"), ("area", "ncol"),
                     ("hyai", "ilev"), ("hybi", "ilev"), ("hyam", "lev"),
                     ("hybm", "lev")):
            f.createVariable(k, "d", (d,))[:] = getattr(g, k).numpy()
        f.createVariable("P0", "d", ())[...] = 1.0e5
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_scale_bench_prints_jax_records(grid_dir):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = scale_bench.main(["--devices", "1", "2", "--nlat", "8",
                               "--nlon", "16", "--steps", "2",
                               "--platform", "cpu"])
    assert rc == 0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [r["devices"] for r in lines] == [1, 2]
    for r in lines:
        assert set(r) == {"devices", "gridpoints_per_s", "scaling_efficiency"}
        assert r["gridpoints_per_s"] > 0
    assert lines[0]["scaling_efficiency"] == 1.0


def test_scale_bench_refuses_more_ranks_than_cards(grid_dir):
    """Without --platform cpu the ranks are NCCL ranks, one card each: a
    device count past the machine's cards raises before any rank starts."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="CUDA devices"):
        scale_bench.main(["--devices", str(n)])
