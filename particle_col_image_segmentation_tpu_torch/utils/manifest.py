"""Restartable-batch progress manifest (SURVEY.md §5).

The reference's only resume-adjacent behavior is the density CSV's
read-modify-rewrite dedup (tiff_analysis.py:1084-1101).  For whole-experiment
batch runs the framework keeps a JSONL manifest of completed work units so an
interrupted run resumes where it stopped (failure detection / elastic
recovery analogue for a data pipeline — there is no model state to
checkpoint).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Set


class RunManifest:
    """Append-only JSONL of completed work-unit keys."""

    def __init__(self, path: str):
        self.path = path
        self._done: Set[str] = set()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn write from a crash — ignore the tail
                    if rec.get("status") == "done":
                        self._done.add(rec["key"])

    def is_done(self, key: str) -> bool:
        return key in self._done

    def mark_done(self, key: str, meta: Optional[Dict] = None) -> None:
        rec = {"key": key, "status": "done", "ts": time.time()}
        if meta:
            rec["meta"] = meta
        with open(self.path, "ab+") as f:
            # a crash can leave a torn partial last line (ignored on load);
            # appending onto it would weld this record into the garbage and
            # lose BOTH — terminate the tail first
            f.seek(0, os.SEEK_END)
            if f.tell() > 0:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
            f.write((json.dumps(rec) + "\n").encode())
            f.flush()
            os.fsync(f.fileno())
        self._done.add(key)

    @property
    def done_count(self) -> int:
        return len(self._done)
