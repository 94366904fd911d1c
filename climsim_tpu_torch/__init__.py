"""climsim_tpu_torch — the PyTorch + CUDA port of ``climsim_tpu``.

The port runs the online hybrid coupled step (the BiGRU emulator in its
v6, v5, batch-major v2 or scan arm + spherical or flat finite-volume,
semi-Lagrangian and vertical transport + water/energy fixers), the
rollout training of the flagship emulator (``train.RolloutTrainer``) and
the physics-constrained emulator with differentiable radiation
(``PhysicalRNNAutoreg``, evaluated and trained by the trainer) on an
NVIDIA Hopper GPU. Ground rules:

* The JAX package ``climsim_tpu`` is the reference and stays as it is.
  This package mirrors its module paths and public names
  (``climsim_tpu_torch/online/host_loop.py::HybridLoop`` is the
  counterpart of ``climsim_tpu/online/host_loop.py::HybridLoop``), with
  the insides written in PyTorch idiom: ``nn.Module``s, plain functions
  on tensors, an explicit ``device``, explicit ``torch.Generator``s and a
  Python loop where JAX has ``lax.scan``.
* This package imports ``torch`` and never ``jax``, ``flax`` or anything
  of ``climsim_tpu``; it keeps its own copy of what it needs (see
  ``constants.py``). Only the tests import both packages.
* Entry points (``RNNAutoreg``, ``PhysicalRNNAutoreg``, ``HybridLoop``,
  ``RolloutTrainer``) take ``device=None``, which means ``"cuda"``;
  without a CUDA device they raise unless the caller passes
  ``device="cpu"``.
* Every Pallas kernel on the ported path has a hand-written CUDA C++
  kernel for ``sm_90a`` under ``ops/csrc/``. Its wrapper dispatches by the
  tensor's device with no fallback: a CPU tensor runs the plain PyTorch
  version, a CUDA tensor launches the kernel or raises. The kernels are
  compiled with ``nvcc`` at first use (``ops/_build.py``), so importing
  this package needs neither ``nvcc`` nor a GPU.
"""
from . import constants
from .grid import Grid
# online before ops: online.advection holds the stencil's plain version,
# which ops.pallas_stencil imports, and online.host_loop imports ops
from .online import HybridLoop, HostLoopConfig
from .models import PhysicalRNNAutoreg, RNNAutoreg, from_flax_params
from . import train

__version__ = "0.1.0"
__all__ = ["constants", "Grid", "HybridLoop", "HostLoopConfig",
           "PhysicalRNNAutoreg", "RNNAutoreg", "from_flax_params", "train"]
