"""Training-loop sinks, PyTorch port of ``moss_ttsd_tpu/train/telemetry.py``.

Every logged step goes to:
  * ``<output_dir>/train_log.jsonl`` — the record of the run;
  * the process-wide registry ``utils/profiling.metrics`` as ``train_*``
    gauges (``train_step``, ``train_loss``, ...);
  * tensorboard event files under ``<output_dir>/tb`` when
    ``use_tensorboard`` and ``torch.utils.tensorboard`` imports (it needs
    the ``tensorboard`` package; without it the other two sinks run).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

from ..utils.profiling import metrics


class TrainLogger:
    def __init__(self, output_dir: str, use_tensorboard: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.jsonl_path = os.path.join(output_dir, "train_log.jsonl")
        self._f = open(self.jsonl_path, "a")
        self.tb = None
        # the writer is made at the first log(), so a run that never logs
        # writes no event files
        self._tb_dir = (os.path.join(output_dir, "tb") if use_tensorboard
                        else None)

    def _ensure_tb(self) -> None:
        if self._tb_dir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.tb = None
        else:
            self.tb = SummaryWriter(self._tb_dir)
        self._tb_dir = None

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        self._ensure_tb()
        scalars = {k: float(v) for k, v in scalars.items()}
        self._f.write(json.dumps({"step": int(step), "time": time.time(),
                                  **scalars}) + "\n")
        self._f.flush()
        metrics.set("train_step", float(step))
        for k, v in scalars.items():
            metrics.set(f"train_{k}", v)
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(f"train/{k}", v, step)

    def close(self) -> None:
        self._f.close()
        if self.tb is not None:
            self.tb.flush()
            self.tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
