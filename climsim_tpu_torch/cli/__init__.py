"""Command-line entry points (counterpart of ``climsim_tpu/cli``), each run
as ``python -m climsim_tpu_torch.cli.<name>``. Ported: ``run_hybrid``."""
