"""Deployment export (counterpart of ``climsim_tpu/export``): the
raw-units online wrapper, its ``torch.export`` artifact, the offline
validation harness and the int8 serving forward."""
from .wrapper import OnlineWrapper, WrapperConfig, flat_output
from .serialize import export_step, load_step, export_wrapper

__all__ = ["OnlineWrapper", "WrapperConfig", "flat_output", "export_step",
           "load_step", "export_wrapper"]
