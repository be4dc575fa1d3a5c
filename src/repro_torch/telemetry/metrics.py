"""``MetricsSink`` — append-only JSONL metrics stream.

One JSON object per line; the file is opened in append mode so successive
runs (or a resumed run after a kill) extend the stream instead of
truncating it, and every write is flushed so a killed process loses at
most the in-flight row. A copy of the JAX package's module of the same
name.
"""
from __future__ import annotations

import json
from typing import IO, Optional


class MetricsSink:
    def __init__(self, path: str):
        self.path = path
        self._f: Optional[IO[str]] = None
        self.n_rows = 0

    def write(self, row: dict) -> None:
        if self._f is None:
            self._f = open(self.path, "a")
        self._f.write(json.dumps(row, sort_keys=True) + "\n")
        self._f.flush()
        self.n_rows += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
