"""The port's storage data plane, after the JAX package's `repro.io` and
byte-compatible with it. Layering, bottom up:

  serde    tensors <-> bytes parts (zero-copy out, view-or-copy back)
  codecs   bytes <-> bytes (raw / zlib / byteplane), self-describing
           vectored container (`encode_parts`)
  bufpool  aligned reusable host buffers, registered with CUDA on the
           card
  backend  StorageBackend interface (write/write_parts/read/readinto)
           + IoStats (with copy accounting) + registry
  backends fs | striped | mem | tiered
  aio      O_DIRECT-style direct I/O with depth-N submission
  faults   fault injection over any backend
  factory  SpoolIoConfig / spec string -> backend

The `managed` backend (`repro_torch.cache.manager`) registers itself
here when first asked for.
"""
from repro_torch.io.aio import AioBackend
from repro_torch.io.backend import (BACKENDS, IoStats, StorageBackend,
                                    as_memoryviews, classify_io_error,
                                    get_backend_cls, preadv_all,
                                    pwritev_all, register_backend)
from repro_torch.io.backends import (FilesystemBackend, HostMemoryBackend,
                                     StripedBackend, TieredBackend)
from repro_torch.io.bufpool import AlignedBufferPool, PooledBuffer
from repro_torch.io.codecs import (CODECS, encode_parts, get_codec, pack,
                                   pack_parts, unpack, unpack_aliased)
from repro_torch.io.factory import (backend_from_spec, build_backend,
                                    parse_bytes)
from repro_torch.io.faults import FaultInjectingBackend
from repro_torch.io.serde import (deserialize_leaves, serialize_leaves,
                                  serialize_parts)

__all__ = [
    "BACKENDS", "IoStats", "StorageBackend", "as_memoryviews",
    "classify_io_error", "get_backend_cls", "preadv_all", "pwritev_all",
    "register_backend", "AioBackend", "FaultInjectingBackend",
    "FilesystemBackend", "HostMemoryBackend", "StripedBackend",
    "TieredBackend", "AlignedBufferPool", "PooledBuffer", "CODECS",
    "encode_parts", "get_codec", "pack", "pack_parts", "unpack",
    "unpack_aliased", "backend_from_spec", "build_backend", "parse_bytes",
    "deserialize_leaves", "serialize_leaves", "serialize_parts",
    "CacheConfig", "CacheManager",
]


def __getattr__(name):
    # lazy: repro_torch.cache.manager imports repro_torch.io.backend
    if name in ("CacheConfig", "CacheManager"):
        from repro_torch.cache import manager
        return getattr(manager, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
