"""Optimizer utilities (heat_tpu ``optim/utils.py``)."""

from __future__ import annotations

from typing import Dict

__all__ = ["DetectMetricPlateau"]


class DetectMetricPlateau:
    """A plateau detector with checkpointable state (heat_tpu
    ``utils.py:10``)."""

    def __init__(self, mode: str = "min", patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode} is unknown!")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold mode {threshold_mode} is unknown!")
        self.mode = mode
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.best = float("inf") if mode == "min" else -float("inf")
        self.last_epoch = 0

    def get_state(self) -> Dict:
        """The state as a dictionary (heat_tpu ``utils.py:46``)."""
        return {"mode": self.mode, "patience": self.patience, "threshold": self.threshold,
                "threshold_mode": self.threshold_mode, "cooldown": self.cooldown,
                "cooldown_counter": self.cooldown_counter,
                "num_bad_epochs": self.num_bad_epochs, "best": self.best,
                "last_epoch": self.last_epoch}

    def set_state(self, dic: Dict) -> None:
        """Restore from :meth:`get_state`'s dictionary."""
        for key, value in dic.items():
            setattr(self, key, value)

    def is_better(self, a, best) -> bool:
        if self.mode == "min" and self.threshold_mode == "rel":
            return a < best * (1.0 - self.threshold)
        if self.mode == "min":
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def test_if_improving(self, metrics) -> bool:
        """True when the metric has plateaued: no better value for more than
        ``patience`` epochs (heat_tpu ``utils.py:66``)."""
        current = float(metrics)
        self.last_epoch += 1
        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
            return True
        return False
