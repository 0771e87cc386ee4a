"""Convergence tracking + CSV/JSONL experiment logging."""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class ConvergenceTracker:
    """Epochs/time to reach targets; smoothed metric series."""

    higher_is_better: bool = False
    ema: float = 0.0
    _ema_init: bool = False
    series: List[Dict] = dataclasses.field(default_factory=list)

    def update(self, *, step: int, epoch: float, sim_time: float,
               metric: Optional[float], ema_alpha: float = 0.3) -> None:
        if metric is not None:
            if not self._ema_init:
                self.ema, self._ema_init = metric, True
            else:
                self.ema = (1 - ema_alpha) * self.ema + ema_alpha * metric
        self.series.append({"step": step, "epoch": epoch,
                            "sim_time": sim_time, "metric": metric,
                            "ema": self.ema if self._ema_init else None})

    def first_reaching(self, target: float, key: str = "epoch"
                       ) -> Optional[float]:
        for r in self.series:
            m = r["metric"]
            if m is None:
                continue
            if (self.higher_is_better and m >= target) or \
               (not self.higher_is_better and m <= target):
                return r[key]
        return None

    def best(self) -> Optional[float]:
        vals = [r["metric"] for r in self.series if r["metric"] is not None]
        if not vals:
            return None
        return max(vals) if self.higher_is_better else min(vals)


class RunLogger:
    """Append-only JSONL run log + optional CSV mirror."""

    def __init__(self, path: str, *, csv_mirror: bool = False):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._csv = None
        self._csv_writer = None
        if csv_mirror:
            self._csv = open(path.replace(".jsonl", "") + ".csv", "w",
                             newline="")
        self.t0 = time.time()

    def log(self, record: Dict) -> None:
        record = dict(record, wall_s=round(time.time() - self.t0, 2))
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._csv is not None:
            if self._csv_writer is None:
                self._csv_writer = csv.DictWriter(
                    self._csv, fieldnames=sorted(record))
                self._csv_writer.writeheader()
            self._csv_writer.writerow(
                {k: record.get(k) for k in self._csv_writer.fieldnames})
            self._csv.flush()

    def close(self) -> None:
        if self._csv is not None:
            self._csv.close()
