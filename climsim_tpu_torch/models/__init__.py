from .rnn import RNNAutoreg
from .phys_rnn import PhysicalRNNAutoreg
from .phys_rad import RadiationModule
from .mlp import MLP, input_prune_mask, mlp_for, output_prune_mask
from .cnn import CNN, reshape_input_for_cnn, reshape_target_from_cnn
from .ed import ED
from .convert import from_flax_params, from_optax_adam
from .common import Policy, F32, BF16

__all__ = ["RNNAutoreg", "PhysicalRNNAutoreg", "RadiationModule", "MLP",
           "mlp_for", "output_prune_mask", "input_prune_mask", "CNN",
           "reshape_input_for_cnn", "reshape_target_from_cnn", "ED",
           "from_flax_params", "from_optax_adam", "Policy", "F32", "BF16"]
