"""Backend construction from declarative config (`SpoolIoConfig`) and
from compact CLI spec strings, a copy of the JAX package's
`repro/io/factory.py`.

Spec grammar (CLI surface, `--spool-backend`-style flags):

    fs                      filesystem under the default spool dir
    fs:/path                filesystem at /path
    mem                     host-RAM tier
    striped:/a,/b           stripe across the listed directories
    striped@4               stripe across 4 subdirs of the default dir
    striped:/base@4         stripe across 4 subdirs of /base
    tiered:64mb             RAM budget 64 MiB over fs default
    tiered:64mb,<spec>      RAM budget over any lower spec (recursive)
    managed:64mb            cache-manager brain, 64 MiB host bound, fs SSD
    managed:64mb,<spec>     ... over any lower spec (recursive)
    aio                     O_DIRECT data plane under the default dir
    aio:/path@8             O_DIRECT at /path, submission depth 8
    fault:<spec>            fault-injection wrapper over any lower spec
    fault@2:mem             ... failing the first 2 writes (tests)
"""
from __future__ import annotations

import os
import tempfile
from typing import List, Optional

from repro_torch.io.aio import AioBackend
from repro_torch.io.backend import StorageBackend, get_backend_cls
from repro_torch.io.backends import (FilesystemBackend, HostMemoryBackend,
                                     StripedBackend, TieredBackend)
from repro_torch.io.faults import FaultInjectingBackend

_SUFFIX = {"kb": 1 << 10, "mb": 1 << 20, "gb": 1 << 30, "tb": 1 << 40,
           "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40,
           "b": 1}


def parse_bytes(text: str) -> int:
    """'64mb' / '1g' / '4096' -> bytes."""
    s = str(text).strip().lower()
    for suf in sorted(_SUFFIX, key=len, reverse=True):
        if s.endswith(suf):
            return int(float(s[:-len(suf)]) * _SUFFIX[suf])
    return int(float(s))


def _default_dir(base_dir: Optional[str],
                 created: Optional[List[str]] = None) -> str:
    if base_dir:
        return base_dir
    d = tempfile.mkdtemp(prefix="tba_spool_")
    if created is not None:
        created.append(d)
    return d


def _stripe_dirs(base: str, n: int) -> List[str]:
    return [os.path.join(base, f"stripe{i}") for i in range(n)]


def _own_tmpdirs(backend: StorageBackend,
                 created: List[str]) -> StorageBackend:
    # Temp dirs the factory invented (no user-named directory) are the
    # caller's to remove on close: advertise them so the spool removes
    # them instead of leaking tba_spool_* dirs.
    backend.owned_tmpdirs = tuple(created)
    return backend


def backend_from_spec(spec: str, *,
                      base_dir: Optional[str] = None) -> StorageBackend:
    spec = (spec or "fs").strip()
    kind, _, rest = spec.partition(":")
    if "@" in kind:                       # striped@N / fault@N shorthand
        kind, _, n = kind.partition("@")
        if kind == "fault":               # fault@N:<inner> keeps <inner>
            rest = f"@{n}:{rest}" if rest else f"@{n}"
        else:
            rest = f"@{n}"
    get_backend_cls(kind)                 # fail fast on unknown kinds
    created: List[str] = []
    if kind == "fs":
        return _own_tmpdirs(
            FilesystemBackend(rest or _default_dir(base_dir, created)),
            created)
    if kind == "aio":
        depth = 4
        if "@" in rest:
            rest, _, d = rest.rpartition("@")
            depth = int(d)
        return _own_tmpdirs(
            AioBackend(rest or _default_dir(base_dir, created),
                       queue_depth=depth),
            created)
    if kind == "mem":
        return HostMemoryBackend()
    if kind == "striped":
        if rest.startswith("@"):
            dirs = _stripe_dirs(_default_dir(base_dir, created),
                                int(rest[1:]))
        elif "@" in rest:
            base, _, n = rest.rpartition("@")
            dirs = _stripe_dirs(base, int(n))
        elif rest:
            dirs = [d for d in rest.split(",") if d]
        else:
            dirs = _stripe_dirs(_default_dir(base_dir, created), 2)
        return _own_tmpdirs(StripedBackend(dirs), created)
    if kind == "tiered":
        budget, _, lower_spec = rest.partition(",")
        if not budget:
            raise ValueError("tiered spec needs a RAM budget, e.g. "
                             "'tiered:64mb'")
        lower = backend_from_spec(lower_spec or "fs", base_dir=base_dir)
        created += list(getattr(lower, "owned_tmpdirs", ()))
        return _own_tmpdirs(
            TieredBackend(lower, capacity_bytes=parse_bytes(budget)),
            created)
    if kind == "managed":
        # imported here, not at module top: the manager module itself
        # imports repro_torch.io.backend, so an eager import would cycle
        # when repro_torch.cache loads first
        from repro_torch.cache.manager import CacheManager
        budget, _, lower_spec = rest.partition(",")
        if not budget:
            raise ValueError("managed spec needs a host-RAM bound, e.g. "
                             "'managed:64mb'")
        lower = backend_from_spec(lower_spec or "fs", base_dir=base_dir)
        created += list(getattr(lower, "owned_tmpdirs", ()))
        return _own_tmpdirs(
            CacheManager(lower, host_bound_bytes=parse_bytes(budget)),
            created)
    if kind == "fault":
        fail_writes = 0
        if rest.startswith("@"):          # fault@N:<inner>
            n, _, rest = rest[1:].partition(":")
            fail_writes = int(n)
        inner = backend_from_spec(rest or "mem", base_dir=base_dir)
        created += list(getattr(inner, "owned_tmpdirs", ()))
        return _own_tmpdirs(
            FaultInjectingBackend(inner, fail_writes=fail_writes),
            created)
    raise ValueError(f"unhandled backend spec {spec!r}")


def build_backend(io_cfg, *,
                  default_dir: Optional[str] = None) -> StorageBackend:
    """Construct a backend from a `repro_torch.configs.SpoolIoConfig`
    (duck-typed so `repro_torch.io` stays import-independent of
    configs)."""
    kind = io_cfg.backend
    if ":" in kind or "@" in kind or kind == "fault":
        # full spec string ("fault@2:striped:/a,/b") — the spec grammar
        # subsumes every per-field knob except the chunk/budget ones,
        # which specs carry inline
        return backend_from_spec(kind,
                                 base_dir=io_cfg.directory or default_dir)
    get_backend_cls(kind)
    created: List[str] = []

    def directory() -> str:
        # resolved lazily: only the branches that actually store to a
        # directory may mkdtemp one
        return io_cfg.directory or _default_dir(default_dir, created)

    if kind == "mem":
        return HostMemoryBackend()
    if kind == "fs":
        return _own_tmpdirs(FilesystemBackend(directory()), created)
    if kind == "aio":
        return _own_tmpdirs(
            AioBackend(directory(),
                       alignment=getattr(io_cfg, "alignment", 4096),
                       queue_depth=getattr(io_cfg, "queue_depth", 4),
                       pool_bytes=getattr(io_cfg, "pool_bytes",
                                          256 << 20)),
            created)
    if kind == "striped":
        dirs = list(io_cfg.stripe_dirs) or _stripe_dirs(directory(), 2)
        return _own_tmpdirs(
            StripedBackend(dirs, chunk_bytes=io_cfg.stripe_chunk_bytes),
            created)
    if kind == "tiered":
        if io_cfg.stripe_dirs:
            lower: StorageBackend = StripedBackend(
                list(io_cfg.stripe_dirs),
                chunk_bytes=io_cfg.stripe_chunk_bytes)
        else:
            lower = FilesystemBackend(directory())
        return _own_tmpdirs(
            TieredBackend(lower,
                          capacity_bytes=io_cfg.host_mem_budget_bytes),
            created)
    if kind == "managed":
        from repro_torch.cache.manager import CacheConfig, CacheManager
        # SSD tier: the --cache-ssd spec when given, else the same
        # stripe-dirs/directory resolution the tiered backend uses
        ssd_spec = getattr(io_cfg, "cache_ssd", None)
        if ssd_spec:
            lower = backend_from_spec(ssd_spec, base_dir=default_dir)
            created += list(getattr(lower, "owned_tmpdirs", ()))
        elif io_cfg.stripe_dirs:
            lower = StripedBackend(list(io_cfg.stripe_dirs),
                                   chunk_bytes=io_cfg.stripe_chunk_bytes)
        else:
            lower = FilesystemBackend(directory())
        cfg = CacheConfig(
            host_bound_bytes=io_cfg.host_mem_budget_bytes,
            promote_depth=getattr(io_cfg, "cache_promote_depth", 2))
        return _own_tmpdirs(CacheManager(lower, config=cfg), created)
    raise ValueError(f"unhandled backend kind {kind!r}")
