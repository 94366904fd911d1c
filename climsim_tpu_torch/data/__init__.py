"""Training and initial-state data (counterpart of ``climsim_tpu/data``).

Ported: the synthetic state generator (``synthetic.generate_state``).
"""
from .synthetic import SyntheticConfig, generate_state

__all__ = ["SyntheticConfig", "generate_state"]
