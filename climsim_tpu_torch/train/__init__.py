"""Rollout training of the emulator (counterpart of
``climsim_tpu/train``): the trainer, its losses and LR schedules."""
from . import losses, schedules
from .rollout import (RolloutConfig, RolloutTrainer, channel_major_apply,
                      make_optimizer, make_schedule, phys_apply,
                      phys_mem_shape)

__all__ = ["losses", "schedules", "RolloutConfig", "RolloutTrainer",
           "channel_major_apply", "make_optimizer", "make_schedule",
           "phys_apply", "phys_mem_shape"]
