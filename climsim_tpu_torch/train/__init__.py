"""Training (counterpart of ``climsim_tpu/train``): the offline loop of
the flat baselines, the rollout trainer, their losses and LR schedules.
``make_optimizer`` here is the rollout trainer's; the offline loop's is
``loop.make_optimizer``."""
from . import losses, schedules
from .loop import (FitConfig, TrainState, fit, init_state, make_eval_step,
                   make_train_step, restore_checkpoint, save_checkpoint)
from .rollout import (RolloutConfig, RolloutTrainer, channel_major_apply,
                      make_optimizer, make_schedule, phys_apply,
                      phys_mem_shape)

__all__ = ["losses", "schedules", "FitConfig", "TrainState", "fit",
           "init_state", "make_train_step", "make_eval_step",
           "save_checkpoint", "restore_checkpoint", "RolloutConfig",
           "RolloutTrainer", "channel_major_apply", "make_optimizer",
           "make_schedule", "phys_apply", "phys_mem_shape"]
