from .rnn import RNNAutoreg
from .phys_rnn import PhysicalRNNAutoreg
from .phys_rad import RadiationModule
from .convert import from_flax_params, from_optax_adam
from .common import Policy, F32, BF16

__all__ = ["RNNAutoreg", "PhysicalRNNAutoreg", "RadiationModule",
           "from_flax_params", "from_optax_adam", "Policy", "F32", "BF16"]
