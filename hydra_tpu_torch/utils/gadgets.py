"""Small utilities — equivalent of src/gadgets.{hpp,cpp} (Timer, Tokenizer)."""

from __future__ import annotations

import time
from typing import List


class Timer:
    """Wall-clock timer (gadgets.hpp Timer / mpi_utils.hpp:8-14 mysecond)."""

    def __init__(self):
        self._t0 = time.time()

    def set_time(self) -> None:
        self._t0 = time.time()

    def elapsed(self) -> float:
        return time.time() - self._t0

    @staticmethod
    def format(seconds: float) -> str:
        h = int(seconds // 3600)
        m = int((seconds % 3600) // 60)
        s = seconds % 60
        return f"{h:02d}:{m:02d}:{s:06.3f}"


def tokenize(text: str, seps: str) -> List[str]:
    """Split on any of the separator characters, dropping empties
    (gadgets.cpp Tokenizer::getTokens)."""
    out, cur = [], []
    sepset = set(seps)
    for ch in text:
        if ch in sepset:
            if cur:
                out.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out
