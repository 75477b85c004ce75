"""The port's storage data plane: RSA2 serde, codecs and the fs / mem
backends, byte-compatible with the JAX package's `repro.io`."""
from repro_torch.io.backend import IoStats, StorageBackend
from repro_torch.io.backends import FilesystemBackend, HostMemoryBackend
from repro_torch.io.codecs import encode_parts, get_codec, pack, unpack
from repro_torch.io.serde import (deserialize_leaves, serialize_leaves,
                                  serialize_parts)

__all__ = ["IoStats", "StorageBackend", "FilesystemBackend",
           "HostMemoryBackend", "encode_parts", "get_codec", "pack",
           "unpack", "deserialize_leaves", "serialize_leaves",
           "serialize_parts"]
