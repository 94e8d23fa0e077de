"""Utilities: the metrics registry, profiling, fault injection, the program
cache, checkpointing, state carried across from numpy, the data tools and
the vision transforms."""

from . import metrics
from . import profiling
from . import faults
from . import program_cache
from . import checkpointing
from . import convert
from . import data
from . import vision_transforms
from .checkpointing import (CheckpointManager, checkpoint_estimator, load_checkpoint,
                            restore_estimator, run_with_recovery, save_checkpoint)

__all__ = ["checkpointing", "convert", "data", "faults", "metrics", "profiling", "program_cache",
           "vision_transforms", "CheckpointManager", "checkpoint_estimator", "load_checkpoint",
           "restore_estimator", "run_with_recovery", "save_checkpoint"]
