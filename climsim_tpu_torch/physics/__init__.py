"""Physics of the ported paths (counterpart of ``climsim_tpu/physics``):
conservation residuals of the training loss, saturation thermodynamics,
the radiation solvers and their helpers, and E3SM cloud optics."""
from . import cloud_optics, conservation, radiation, thermo

__all__ = ["cloud_optics", "conservation", "radiation", "thermo"]
