"""Early stopping on a monitored metric (host copy of
`lpi_tpu/continual/early_stop.py`): stop when the monitored value fails to
improve for `patience` consecutive evaluations (the reference's
`SOLVER.AUTO_TERMINATE_PATIENCE`)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class EarlyStopper:
    patience: int = 8
    mode: str = "max"  # max | min
    best: float = field(default=None, init=False)  # type: ignore[assignment]
    bad_count: int = field(default=0, init=False)

    def update(self, value: float) -> bool:
        """Record a new metric value; True when training should stop."""
        if self.patience <= 0:
            return False
        improved = (
            self.best is None
            or (self.mode == "max" and value > self.best)
            or (self.mode == "min" and value < self.best)
        )
        if improved:
            self.best = value
            self.bad_count = 0
        else:
            self.bad_count += 1
        return self.bad_count >= self.patience
