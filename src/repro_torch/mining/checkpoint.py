"""Restartable state of a level-synchronous mine, as JSON on disk.

The format is the JAX package's (``repro.mining.distributed``), key for key,
so a checkpoint written by either package resumes in the other.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Hashable, Optional, Tuple

Item = Hashable


@dataclass
class MiningCheckpoint:
    """Restartable state of a level-synchronous mine.

    ``level``/``frequent`` record the last COMPLETED level; the optional
    ``partial`` dict records an in-flight level of a streaming sweep
    ({level, itemsets, next_chunk, acc}) so a restart resumes mid-level from
    the last completed chunk (see ``mining/stream.py``).
    """
    path: str

    def save(self, level: int, frequent: Dict[Tuple[Item, ...], int],
             meta: Optional[dict] = None,
             partial: Optional[dict] = None) -> None:
        tmp = self.path + ".tmp"
        payload = {
            "level": level,
            "frequent": [[list(k), int(v)] for k, v in frequent.items()],
            "meta": meta or {},
            "partial": partial,
        }
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)  # atomic

    def load(self) -> Optional[Tuple[int, Dict[Tuple[Item, ...], int], dict]]:
        state = self.load_state()
        if state is None:
            return None
        return state["level"], state["frequent"], state["meta"]

    def load_state(self) -> Optional[dict]:
        """Full state incl. the mid-level ``partial`` record (or None).
        A missing or EMPTY file means no state: saves are atomic (write tmp
        + rename), so a 0-byte file can only be a pre-created placeholder
        (e.g. ``mkstemp``), never a torn write."""
        if not os.path.exists(self.path) or os.path.getsize(self.path) == 0:
            return None
        with open(self.path) as f:
            payload = json.load(f)
        freq = {tuple(k): v for k, v in payload["frequent"]}
        return {
            "level": payload["level"],
            "frequent": freq,
            "meta": payload.get("meta", {}),
            "partial": payload.get("partial"),
        }
