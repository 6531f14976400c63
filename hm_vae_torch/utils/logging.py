"""Metric logging: JSON lines, mirrored to TensorBoard when it is importable.

Port of ``hm_vae_tpu.utils.logging`` (``MetricWriter``,
``make_result_folders``): metrics are an explicit dict, every record is one
JSON line in ``metrics.jsonl`` for machine reading.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def write(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        scalars = {(prefix + k): float(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": int(step), "time": time.time(), **scalars}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def make_result_folders(output_directory: str):
    """checkpoints/ + images/ under the run dir."""
    image_directory = os.path.join(output_directory, "images")
    checkpoint_directory = os.path.join(output_directory, "checkpoints")
    os.makedirs(image_directory, exist_ok=True)
    os.makedirs(checkpoint_directory, exist_ok=True)
    return checkpoint_directory, image_directory
