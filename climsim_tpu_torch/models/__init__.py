from .rnn import RNNAutoreg
from .convert import from_flax_params, from_optax_adam
from .common import Policy, F32, BF16

__all__ = ["RNNAutoreg", "from_flax_params", "from_optax_adam", "Policy",
           "F32", "BF16"]
