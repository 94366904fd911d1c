"""Physics invariants used by the training losses (counterpart of
``climsim_tpu/physics``; only ``conservation`` is ported)."""
from . import conservation

__all__ = ["conservation"]
