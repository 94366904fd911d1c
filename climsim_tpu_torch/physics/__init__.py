"""Physics of the ported paths (counterpart of ``climsim_tpu/physics``):
conservation residuals of the training loss, saturation thermodynamics,
the radiation solvers and their helpers, E3SM cloud optics, and the
cloud-condensate feature transforms."""
from . import cloud_optics, conservation, radiation, thermo, transforms

__all__ = ["cloud_optics", "conservation", "radiation", "thermo",
           "transforms"]
