"""The dry run's fourth part, ensemble-parallel RPN training
(``cli/dryrun_multichip.py::ensemble_step``), on the CPU: the CLI on 4
gloo ranks (a 2 x 2 (data, ensemble) mesh) prints JAX's four lines, the
ensemble step's after holding every rank's members to the same step of
the whole ensemble on one device: the gradient averaged over the data
group within rtol 1e-6 plus 1e-6 of the tensor's largest |g|, before the
Adam step (whose first update does not see a gradient's scale), and the
weights after it within rtol 1e-6 plus 1e-3 of the learning rate (the
all-reduce sums in another order); and the step on a one-rank (1, 1)
mesh equals the single-device step bit for bit."""
import os
import re
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from climsim_tpu_torch.cli import dryrun_multichip
from climsim_tpu_torch.parallel import init_distributed
from test_torch_train_cli import write_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_four_ranks(tmp_path):
    """As a user runs it, from a directory holding a grid file at its
    default place; the run has a time limit of its own (300 s; it takes
    ~15 s)."""
    os.makedirs(tmp_path / "grid_info")
    write_grid(str(tmp_path / "grid_info" / "ClimSim_low-res_grid-info.nc"),
               384)
    out = subprocess.run([sys.executable, "-m",
                          "climsim_tpu_torch.cli.dryrun_multichip",
                          "--devices", "4", "--device", "cpu"],
                         cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("dryrun_multichip(4)")]
    assert len(lines) == 4 and all(ln.endswith("OK") for ln in lines)
    assert re.fullmatch(r"dryrun_multichip\(4\): ensemble-parallel "
                        r"\(data=2 x ens=2\) loss=\d+\.\d{4} OK", lines[3])


def test_ensemble_step_one_rank_is_the_single_device_step():
    init_distributed(device="cpu")
    try:
        loss = dryrun_multichip.ensemble_step(1, 1, torch.device("cpu"),
                                              np.random.default_rng(0))
    finally:
        dist.destroy_process_group()
    assert np.isfinite(loss) and loss > 0
