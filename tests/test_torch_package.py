"""Ground rules of the PyTorch port: it imports nothing of JAX or of the
JAX package, its entry points default to the card, and importing it needs
neither nvcc nor triton."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "climsim_tpu_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    for want in ("chip_smoke.py", "climsim_tpu_torch/ops/pallas_rnn.py",
                 "climsim_tpu_torch/ops/pallas_stencil.py",
                 "climsim_tpu_torch/online/host_loop.py",
                 "climsim_tpu_torch/models/rnn.py",
                 "climsim_tpu_torch/train/rollout.py",
                 "climsim_tpu_torch/physics/conservation.py",
                 "climsim_tpu_torch/physics/radiation.py",
                 "climsim_tpu_torch/ops/pallas_radiation.py",
                 "climsim_tpu_torch/models/phys_rnn.py",
                 "climsim_tpu_torch/io/cdf5.py",
                 "climsim_tpu_torch/io/ncio.py",
                 "climsim_tpu_torch/variables.py",
                 "climsim_tpu_torch/data/synthetic.py",
                 "climsim_tpu_torch/cli/run_hybrid.py"):
        assert want in names
    for cu in ("bigru_heads_init_cm.cu", "bigru_heads_cm_bwd.cu",
               "fv_tracers_sphere.cu", "bigru_lbh.cu", "adding_sw.cu",
               "lw_noscat.cu", "bigru_lbh_bwd.cu", "adding_sw_bwd.cu",
               "lw_noscat_bwd.cu", "bigru_heads_cm.cu",
               "fv_tracers_flat.cu", "bigru_heads_lbh.cu"):
        assert (PORT / "ops" / "csrc" / cu).is_file()
    from climsim_tpu_torch.ops import _build
    assert {p.stem for p in (PORT / "ops" / "csrc").glob("*.cu")} \
        == set(_build.SOURCES)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    for mod in _imported_roots(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "climsim_tpu"), \
            f"{path.name} imports {mod}"


def test_entry_points_default_to_cuda():
    from climsim_tpu_torch import Grid, HostLoopConfig, HybridLoop, RNNAutoreg
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    kw = dict(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(8, 8), nh_mem=4,
              add_pres=False, use_pallas=True, fuse_heads=True,
              fuse_init=True, level_major=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        RNNAutoreg(**kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        HybridLoop(None, Grid.synthetic(24, 4),
                   HostLoopConfig(nlat=4, nlon=6, emulator_level_major=True))
    assert RNNAutoreg(device="cpu", **kw).device.type == "cpu"


ARMS = {"v5": dict(use_pallas=True, fuse_heads=True, level_major=True),
        "v2": dict(use_pallas=True), "scan": {},
        "v3": dict(use_pallas=True, fuse_heads=True),
        "v4": dict(use_pallas=True, fuse_heads=True, fuse_init=True)}
CONFIGS = {"flat": dict(geometry="flat", use_pallas=True),
           "semi_lagrangian": dict(scheme="semi_lagrangian"),
           "vertical": dict(vertical_advection=True),
           "none": dict(scheme="none"),
           "batch_major": dict(emulator_level_major=False)}


@pytest.mark.parametrize("arm", list(ARMS))
def test_new_arms_default_to_cuda(arm):
    """RNNAutoreg in each arm this slice ports runs on the card unless
    the caller asks for the CPU."""
    from climsim_tpu_torch import RNNAutoreg
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    kw = dict(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(8, 8), nh_mem=4,
              add_pres=False, **ARMS[arm])
    with pytest.raises(RuntimeError, match="CUDA"):
        RNNAutoreg(**kw)
    model = RNNAutoreg(device="cpu", **kw)
    assert model.arm == arm and model.device.type == "cpu"


@pytest.mark.parametrize("config", list(CONFIGS))
def test_new_configs_default_to_cuda(config):
    """HybridLoop in each configuration this slice ports runs on the card
    unless the caller asks for the CPU."""
    from climsim_tpu_torch import Grid, HostLoopConfig, HybridLoop
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = HostLoopConfig(**{"nlat": 4, "nlon": 6,
                            "emulator_level_major": True, **CONFIGS[config]})
    with pytest.raises(RuntimeError, match="CUDA"):
        HybridLoop(None, Grid.synthetic(24, 4), cfg)
    loop = HybridLoop(None, Grid.synthetic(24, 4), cfg, device="cpu")
    assert loop.device.type == "cpu"


def test_import_needs_no_nvcc_or_triton(tmp_path):
    """Import the package in a fresh interpreter where neither nvcc nor
    triton can be found."""
    code = ("import sys; sys.modules['triton'] = None\n"
            "had_jax = 'jax' in sys.modules\n"
            "import climsim_tpu_torch, climsim_tpu_torch.ops\n"
            "assert had_jax or 'jax' not in sys.modules, 'jax was imported'\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_every_jax_module_has_its_counterpart():
    """Each module of the JAX package (listed from the filesystem, not
    imported), ``__init__.py`` files apart, has its counterpart at the
    same path in the port."""
    jax_pkg = ROOT / "climsim_tpu"
    modules = [p.relative_to(jax_pkg) for p in sorted(jax_pkg.rglob("*.py"))
               if p.name != "__init__.py"]
    assert len(modules) > 50
    missing = [m.as_posix() for m in modules if not (PORT / m).is_file()]
    assert not missing, f"no counterpart in climsim_tpu_torch: {missing}"
