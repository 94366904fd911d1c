"""The weighted scoreboard (counterpart of ``climsim_tpu/metrics``):
metric estimators, the output weighting chain, per-variable and
per-level tables, and plots."""
from .metrics import bias, crps, mae, r2, rmse
from .report import evaluate, level_metrics, per_level_table, scoreboard
from .weighting import recover_ps, split_variables, weight_outputs

__all__ = ["mae", "rmse", "r2", "bias", "crps", "weight_outputs",
           "recover_ps", "split_variables", "scoreboard", "level_metrics",
           "evaluate", "per_level_table"]
