"""The port's cache layer, after the JAX package's `repro/cache`: the
reuse horizon, the tier-placement engine and (lazily, to keep the import
graph acyclic: `repro_torch.cache.manager` imports `repro_torch.io`,
whose backends import `repro_torch.cache.placement`) the cache manager.
"""
from __future__ import annotations

from repro_torch.cache.horizon import reuse_horizon
from repro_torch.cache.placement import PlacementEngine

__all__ = [
    "reuse_horizon",
    "PlacementEngine",
    "CacheManager",
    "CacheConfig",
    "DEFAULT_CLASS_DISTANCES",
    "plan_residency",
]

_LAZY = ("CacheManager", "CacheConfig", "DEFAULT_CLASS_DISTANCES",
         "plan_residency")


def __getattr__(name: str):
    if name in _LAZY:
        from repro_torch.cache import manager
        return getattr(manager, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
