"""Metrics logging (port of ``mmvae_tpu/train/metrics.py``).

An ``AverageMeter`` for epoch averages and a JSONL writer: ``api.train``
appends one ``{"kind": "eval", "epoch", "train_loss", "test_elbo"}``
record an epoch to ``<workdir>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

__all__ = ["AverageMeter", "MetricsWriter"]


class AverageMeter:
    """Running average of values, each weighed by its count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def _plain(v):
    """A JSON-ready value: tensors and numpy arrays as numbers or lists."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.ndarray, np.generic)):
        return v.tolist()
    return v


class MetricsWriter:
    """Append-only JSONL metrics sink: one record per call, each with the
    host's ``time`` unless the record carries one."""

    def __init__(self, workdir: str, filename: str = "metrics.jsonl"):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, filename)
        self._fh = open(self.path, "a", buffering=1)

    def write(self, record: dict[str, Any]) -> None:
        rec = {k: _plain(v) for k, v in record.items()}
        rec.setdefault("time", time.time())
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()
