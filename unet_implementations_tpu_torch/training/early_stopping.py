"""Early stopping on a monitored metric.

The port's copy of ``unet_implementations_tpu/training/early_stopping.py``:
a patience counter with ``min_delta=0.001``; an epoch counts as "no
improvement" when ``score < best + min_delta`` (the score negated in mode
'min'). ``state_dict`` / ``load_state_dict`` carry the counter across a
resume, so a resumed run stops at the epoch an uninterrupted one does.
"""

from __future__ import annotations


class EarlyStopping:
    def __init__(self, patience: int = 10, mode: str = "max", min_delta: float = 0.001,
                 verbose: bool = True):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.verbose = verbose
        self.counter = 0
        self.best_score = None
        self.early_stop = False

    def state_dict(self) -> dict:
        return {"counter": self.counter, "best_score": self.best_score}

    def load_state_dict(self, state: dict | None) -> "EarlyStopping":
        if state:
            self.counter = int(state.get("counter", 0))
            best = state.get("best_score")
            self.best_score = None if best is None else float(best)
        return self

    def __call__(self, val_score: float) -> bool:
        score = -val_score if self.mode == "min" else val_score
        if self.best_score is None:
            self.best_score = score
        elif score < self.best_score + self.min_delta:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self.counter = 0
        return self.early_stop
