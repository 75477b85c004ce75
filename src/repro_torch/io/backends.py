"""The port's storage backends, from the JAX package's
`repro/io/backends.py`: one directory (`fs`, the stand-in for one SSD)
and host RAM (`mem`)."""
from __future__ import annotations

import os
import threading
from typing import Dict, List

from repro_torch.io.backend import StorageBackend, pwritev_all

_SUFFIX = ".act"


class FilesystemBackend(StorageBackend):
    """One blob file per key in one directory. Writes are vectored
    (`os.pwritev` over the part list) and rename-atomic: the blob lands
    in a same-directory temp file that replaces the real name only once
    fully written, so a crash mid-store never leaves a truncated blob
    under the final name."""

    kind = "fs"

    def __init__(self, directory: str):
        super().__init__()
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}{_SUFFIX}")

    def _write_parts(self, key: str, parts: List[memoryview]) -> None:
        # pid+tid suffix: concurrent writers of different keys (the
        # spool's store pool) must not collide on temp names
        tmp = f"{self._path(key)}.tmp.{os.getpid()}.{threading.get_ident()}"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            pwritev_all(fd, parts)
        except BaseException:
            os.close(fd)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.close(fd)
        os.replace(tmp, self._path(key))

    def _read(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def _delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self) -> List[str]:
        return sorted(f[:-len(_SUFFIX)] for f in os.listdir(self.directory)
                      if f.endswith(_SUFFIX))


class HostMemoryBackend(StorageBackend):
    """Host-RAM tier: blobs live in a dict."""

    kind = "mem"

    def __init__(self):
        super().__init__()
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def _write_parts(self, key: str, parts: List[memoryview]) -> None:
        data = b"".join(parts)
        with self._lock:
            self._blobs[key] = data

    def _read(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._blobs[key]
            except KeyError:
                raise FileNotFoundError(key) from None

    def _delete(self, key: str) -> None:
        with self._lock:
            self._blobs.pop(key, None)

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._blobs)
