"""Scalar and text logging of a run (port of ocn_tpu/utils/logging.py).

``MetricLogger(logdir)`` appends one JSON record a call to
``logdir/metrics.jsonl``: ``{"t", "tag", "step", **values}`` for
``scalars`` and ``{"t", "tag", "text"}`` for ``text``, the records of the
JAX package's logger.  Where ``torch.utils.tensorboard`` imports, the same
calls also go to a TensorBoard ``SummaryWriter`` in ``logdir``; without
it (as on a machine with no tensorboard package) only the JSONL is written.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(logdir)

    def _write(self, record: dict) -> None:
        self._jsonl.write(json.dumps({"t": time.time(), **record}) + "\n")
        self._jsonl.flush()

    def scalars(self, tag: str, values: Dict[str, float], step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalars(tag, values, step)
        self._write({"tag": tag, "step": step, **values})

    def text(self, tag: str, value: str) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, value)
        self._write({"tag": tag, "text": value})

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
