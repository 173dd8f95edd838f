"""Structured metric logging: stdout, an in-memory record list and JSONL.

Counterpart of ``piml_tpu/utils/logging.py``: the reference logs by bare
``print`` (simulators.py:373-376, 548-552); here every metric record is
printed as one line, kept in ``records`` and, with ``jsonl_path``,
appended to a JSONL file for machine consumption.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None, stream=None):
        self.jsonl_path = jsonl_path
        self.stream = stream
        self.records: List[Dict[str, Any]] = []
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def info(self, msg: str) -> None:
        print(msg, file=self.stream or sys.stdout)

    def log(self, **metrics) -> None:
        self.records.append(metrics)
        self.info(", ".join(f"{k}={v:.6g}" if isinstance(v, float)
                            else f"{k}={v}" for k, v in metrics.items()))
        if self._fh:
            self._fh.write(json.dumps({"ts": time.time(), **metrics}) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
