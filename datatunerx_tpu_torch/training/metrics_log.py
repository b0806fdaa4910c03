"""Training metrics as jsonl (the port of the logger half of
``datatunerx_tpu/training/metrics_log.py``).

``MetricsLogger`` writes ``<output_dir>/watch/trainer_log.jsonl`` and
``eval_log.jsonl`` with the reference's record keys (``current_steps``,
``total_steps``, ``percentage``, ``elapsed_time``, ``eta`` plus the step's
metrics), so the operator's scraper reads either package's runs, and echoes
each record to stdout. Prometheus remote-write, the ``watch/metrics.prom``
mirror and the prefetch advisory are not ported yet (ROADMAP Queue 1 item
12); the CLI refuses ``--metrics_export_address``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, output_dir: str, total_steps: int):
        self.output_dir = output_dir
        self.total_steps = max(total_steps, 1)
        self.start = time.time()
        self.watch_dir = os.path.join(output_dir, "watch")
        os.makedirs(self.watch_dir, exist_ok=True)

    def _common(self, step: int) -> Dict:
        elapsed = time.time() - self.start
        rate = elapsed / max(step, 1)
        return {
            "current_steps": step,
            "total_steps": self.total_steps,
            "percentage": round(step / self.total_steps * 100, 2),
            "elapsed_time": round(elapsed, 3),
            "eta": round(rate * max(self.total_steps - step, 0), 3),
        }

    def _log(self, filename: str, tag: str, step: int,
             metrics: Dict[str, float]):
        rec = {**self._common(step), **{k: _f(v) for k, v in metrics.items()}}
        with open(os.path.join(self.watch_dir, filename), "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[{tag}] {json.dumps(rec)}", flush=True)

    def log_train(self, step: int, metrics: Dict[str, float]):
        self._log("trainer_log.jsonl", "train", step, metrics)

    def log_eval(self, step: int, metrics: Dict[str, float]):
        self._log("eval_log.jsonl", "eval", step, metrics)


def _f(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")
