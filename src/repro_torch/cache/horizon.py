"""The "next needed" prefix (reuse horizon) shared by prefetch sites,
copied from the JAX package's `repro/cache/horizon.py`."""
from __future__ import annotations

from typing import Iterable, List, TypeVar

T = TypeVar("T")


def reuse_horizon(upcoming: Iterable[T], *, depth: int = 1) -> List[T]:
    """The prefix of `upcoming` a prefetcher should cover right now:
    at most `depth` items, in access order (the kvcache passes its resume
    queue and `prefetch_depth`). An exhausted iterable gives []."""
    if depth <= 0:
        return []
    out: List[T] = []
    for item in upcoming:
        out.append(item)
        if len(out) >= depth:
            break
    return out
