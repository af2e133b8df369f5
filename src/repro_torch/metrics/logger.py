"""Structured run metrics: JSONL stream + rolling aggregates (the
reference's ``repro/metrics/logger.py``, copied).

The framework's observability layer (stands in for the TB/W&B sink a
real deployment would attach). Pure stdlib; safe on any host.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class MetricsLogger:
    def __init__(self, run_dir: Optional[str] = None, run_name: str = "run",
                 flush_every: int = 20):
        self.run_dir = run_dir
        self.run_name = run_name
        self.flush_every = flush_every
        self._buf: List[Dict[str, Any]] = []
        self._t0 = time.time()
        self._path = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._path = os.path.join(run_dir, f"{run_name}.jsonl")
            # truncate previous run of the same name
            open(self._path, "w").close()

    def log(self, step: int, **metrics: float) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._buf.append(rec)
        if self._path and len(self._buf) % self.flush_every == 0:
            self.flush()

    def flush(self) -> None:
        if self._path and self._buf:
            with open(self._path, "a") as f:
                for rec in self._buf:
                    f.write(json.dumps(rec) + "\n")
            self._buf.clear()

    def summary(self, key: str, last_k: int = 20) -> Dict[str, float]:
        vals = [r[key] for r in self._buf if key in r]
        if self._path and os.path.exists(self._path):
            with open(self._path) as f:
                vals = [json.loads(l).get(key) for l in f
                        if key in l] + vals
        vals = [v for v in vals if v is not None]
        if not vals:
            return {}
        tail = vals[-last_k:]
        return {"last": vals[-1], "min": min(vals), "max": max(vals),
                "mean_tail": sum(tail) / len(tail), "n": len(vals)}


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]
