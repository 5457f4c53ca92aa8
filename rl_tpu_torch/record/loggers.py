"""Experiment loggers (counterpart of :mod:`rl_tpu.record.loggers`;
``Logger``, ``NullLogger`` and ``CSVLogger`` are ported).

``log_scalars`` reads each 0-dim numeric value on the host (a device
tensor syncs once per value), so a trainer logs only every
``log_interval`` steps.
"""

from __future__ import annotations

import csv as _csv
import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from .._stubs import not_ported

__all__ = ["Logger", "CSVLogger", "NullLogger"]


def _scalar(v) -> float | None:
    if isinstance(v, torch.Tensor):
        if v.dim() != 0 or v.dtype == torch.bool:
            return None
        return float(v.item())
    a = np.asarray(v)
    if a.ndim == 0 and np.issubdtype(a.dtype, np.number):
        return float(a)
    return None


class Logger:
    """Base logger: ``log_scalar`` is the backend's; the rest default to
    nothing."""

    def __init__(self, exp_name: str, log_dir: str | None = None):
        self.exp_name = exp_name
        self.log_dir = log_dir

    def log_scalar(self, name: str, value: float, step: int | None = None) -> None:
        raise NotImplementedError

    def log_scalars(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        for k, v in metrics.items():
            x = _scalar(v)
            if x is not None:
                self.log_scalar(k, x, step)

    def log_video(self, name: str, frames, step: int | None = None, fps: int = 30) -> None:
        pass

    def log_hparams(self, hparams: Mapping[str, Any]) -> None:
        pass

    def log_histogram(self, name: str, values, step: int | None = None) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "Logger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class NullLogger(Logger):
    """Drops everything, and reads nothing on the host."""

    def __init__(self, exp_name: str = "null", log_dir: str | None = None):
        super().__init__(exp_name, log_dir)

    def log_scalar(self, name, value, step=None):
        pass

    def log_scalars(self, metrics, step=None):
        pass


class CSVLogger(Logger):
    """One CSV per scalar stream and a JSON of the hparams, under
    ``log_dir/exp_name``; at most ``max_open_files`` handles stay open
    (the least recently used close and reopen in append mode)."""

    def __init__(self, exp_name: str, log_dir: str = "logs", max_open_files: int = 64):
        super().__init__(exp_name, os.path.join(log_dir, exp_name))
        os.makedirs(self.log_dir, exist_ok=True)
        self.max_open_files = max(1, int(max_open_files))
        self._files: dict[str, Any] = {}  # insertion order is LRU order

    def _writer(self, name: str):
        if name in self._files:
            self._files[name] = entry = self._files.pop(name)
            return entry
        while len(self._files) >= self.max_open_files:
            old_f, _ = self._files.pop(next(iter(self._files)))
            old_f.close()
        f = open(os.path.join(self.log_dir, f"{name.replace('/', '_')}.csv"), "a", newline="")
        self._files[name] = entry = (f, _csv.writer(f))
        return entry

    def log_scalar(self, name, value, step=None):
        f, w = self._writer(name)
        w.writerow([step, value])
        f.flush()

    def log_hparams(self, hparams):
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump({k: str(v) for k, v in dict(hparams).items()}, f, indent=2)

    def log_video(self, name, frames, step=None, fps=30):
        np.save(os.path.join(self.log_dir, f"{name.replace('/', '_')}_{step or 0}.npy"),
                np.asarray(frames))

    def close(self):
        for f, _ in self._files.values():
            f.close()
        self._files.clear()


_ROADMAP = "A7: the logger backends"
TensorboardLogger = not_ported("TensorboardLogger", __name__, _ROADMAP)
WandbLogger = not_ported("WandbLogger", __name__, _ROADMAP)
MLFlowLogger = not_ported("MLFlowLogger", __name__, _ROADMAP)
MultiLogger = not_ported("MultiLogger", __name__, _ROADMAP)
get_logger = not_ported("get_logger", __name__, _ROADMAP)
