from .rnn import RNNAutoreg
from .phys_rnn import PhysicalRNNAutoreg
from .phys_rad import RadiationModule
from .mlp import MLP, input_prune_mask, mlp_for, output_prune_mask
from .cnn import CNN, reshape_input_for_cnn, reshape_target_from_cnn
from .ed import ED
from .hsr import HSR, hsr_nll, hsr_sample
from .cvae import CVAE, cvae_loss, cvae_samples
from .rpn import RPNEnsemble
from .unet import (ClimsimUNet, ClimsimUNetClassifier, classifier_loss,
                   cloud_class_labels, unet_v4, unet_v5)
from .convert import from_flax_params, from_optax_adam
from .ncp import (AutoNCP, CfC, CfCCell, MixedMemoryLSTMCell, NCP,
                  WiredCfCCell, Wiring)
from .common import Policy, F32, BF16

__all__ = ["RNNAutoreg", "PhysicalRNNAutoreg", "RadiationModule", "MLP",
           "mlp_for", "output_prune_mask", "input_prune_mask", "CNN",
           "reshape_input_for_cnn", "reshape_target_from_cnn", "ED",
           "HSR", "hsr_nll", "hsr_sample", "CVAE", "cvae_loss",
           "cvae_samples", "RPNEnsemble", "ClimsimUNet",
           "ClimsimUNetClassifier", "classifier_loss", "cloud_class_labels",
           "unet_v4", "unet_v5",
           "from_flax_params", "from_optax_adam", "Policy", "F32", "BF16",
           "Wiring", "NCP", "AutoNCP", "CfCCell", "WiredCfCCell",
           "MixedMemoryLSTMCell", "CfC"]
