"""Fault-injecting storage backend, a copy of the JAX package's
`repro/io/faults.py`.

Wraps any `StorageBackend` and injects the failure modes a resilient
spool must survive but a healthy CI box never produces on its own:

  * write failures       — the next `fail_writes` eligible writes raise
                           (`OSError` by default, e.g. ENOSPC), leaving
                           the blob unwritten so the spool's
                           failed-store forwarding / retry / error
                           surfacing paths run;
  * raising reads        — the next `fail_reads` eligible read/readinto
                           calls raise (`read_exc`), driving the load
                           worker's retry and the engines'
                           recompute-fallback paths (a short read only
                           corrupts; a raising read is a device gone);
  * short reads          — the next `short_reads` read/readinto calls
                           return `short_by` bytes fewer than the blob
                           holds, driving serde's truncation guards and
                           the load-worker's pool-lease cleanup;
  * intermittent faults  — every write fails with probability
                           `intermittent_rate`, drawn from a *seeded*
                           RNG so chaos runs replay bit-for-bit;
  * ENOSPC after budget  — once `enospc_after_bytes` bytes have been
                           accepted, further writes raise
                           ``OSError(ENOSPC)``: a filling filesystem;
  * delayed completion   — every write (read) sleeps `write_delay`
                           (`read_delay`) seconds first, widening the
                           in-flight windows that tensor forwarding,
                           store cancellation and orphaned-write
                           deletion race against.

Failures can be scoped to keys containing `fail_key_substr` and — when
the inner chain contains a `StripedBackend` — to keys whose stripe
placement *starts* on device `device` (per-stripe-device scoping: kill
the traffic headed at one NVMe, leave its siblings alone). Arming
happens at runtime through `arm_write_failures` / `arm_read_failures` /
`arm_short_reads` / `arm_intermittent` / `arm_enospc`; `injected`
counts what actually fired. The wrapper is registered as backend kind
"fault" and constructible from a spec string — ``fault:<inner-spec>``
or ``fault@N:<inner-spec>`` (fail the first N writes), e.g.
``fault@2:mem`` — so the whole spool stack can be pointed at a faulty
device from config, exactly like any other `repro_torch.io` backend.

The wrapper's own `IoStats` observe the *caller-visible* outcome
(failed writes are not counted as written bytes); the inner backend
keeps its own stats for the traffic that really reached it.
"""
from __future__ import annotations

import errno
import random
import threading
import time
from typing import Dict, List, Optional

from repro_torch.io.backend import StorageBackend, register_backend


@register_backend("fault")
class FaultInjectingBackend(StorageBackend):
    """See module docstring. All delegation reaches the inner backend
    through its PUBLIC methods, so composite inners (striped / tiered /
    aio) keep their own vectored paths and accounting."""

    def __init__(self, inner: StorageBackend, *,
                 fail_writes: int = 0,
                 write_exc: Optional[BaseException] = None,
                 fail_key_substr: Optional[str] = None,
                 fail_reads: int = 0,
                 read_exc: Optional[BaseException] = None,
                 read_key_substr: Optional[str] = None,
                 short_reads: int = 0,
                 short_by: int = 1,
                 intermittent_rate: float = 0.0,
                 intermittent_seed: int = 0,
                 enospc_after_bytes: Optional[int] = None,
                 device: Optional[int] = None,
                 write_delay: float = 0.0,
                 read_delay: float = 0.0):
        super().__init__()
        self.inner = inner
        self.write_delay = write_delay
        self.read_delay = read_delay
        self._flock = threading.Lock()
        self._fail_writes = int(fail_writes)
        self._write_exc = write_exc
        self._fail_key_substr = fail_key_substr
        self._fail_reads = int(fail_reads)
        self._read_exc = read_exc
        self._read_key_substr = read_key_substr
        self._short_reads = int(short_reads)
        self._short_by = int(short_by)
        self._intermittent_rate = float(intermittent_rate)
        self._intermittent_exc: Optional[BaseException] = None
        self._rng = random.Random(intermittent_seed)
        self._enospc_after = enospc_after_bytes
        self._bytes_through = 0
        self._fail_device = device
        self.injected: Dict[str, int] = {"write_failures": 0,
                                         "read_failures": 0,
                                         "short_reads": 0,
                                         "intermittent_failures": 0,
                                         "enospc_failures": 0}
        # mirror the inner's data-plane affordances so the spool makes
        # the same plumbing choices it would against the bare backend
        self.zero_copy_read = inner.zero_copy_read
        self.owned_tmpdirs = tuple(getattr(inner, "owned_tmpdirs", ()))

    @property
    def pool(self):
        return getattr(self.inner, "pool", None)

    @property
    def directory(self):
        return getattr(self.inner, "directory", None)

    # ----------------------------------------------------- arming knobs

    def arm_write_failures(self, n: int, *,
                           exc: Optional[BaseException] = None,
                           key_substr: Optional[str] = None,
                           device: Optional[int] = None) -> None:
        """The next `n` eligible writes raise."""
        with self._flock:
            self._fail_writes = int(n)
            if exc is not None:
                self._write_exc = exc
            self._fail_key_substr = key_substr
            if device is not None:
                self._fail_device = device

    def arm_read_failures(self, n: int, *,
                          exc: Optional[BaseException] = None,
                          key_substr: Optional[str] = None,
                          device: Optional[int] = None) -> None:
        """The next `n` eligible read/readinto calls raise."""
        with self._flock:
            self._fail_reads = int(n)
            if exc is not None:
                self._read_exc = exc
            self._read_key_substr = key_substr
            if device is not None:
                self._fail_device = device

    def arm_short_reads(self, n: int, *, short_by: int = 1) -> None:
        """The next `n` reads come back `short_by` bytes truncated."""
        with self._flock:
            self._short_reads = int(n)
            self._short_by = int(short_by)

    def arm_intermittent(self, rate: float, *, seed: int = 0,
                         exc: Optional[BaseException] = None) -> None:
        """Each write fails with probability `rate` (seeded RNG)."""
        assert 0.0 <= rate <= 1.0
        with self._flock:
            self._intermittent_rate = float(rate)
            self._intermittent_exc = exc
            self._rng = random.Random(seed)

    def arm_enospc(self, after_bytes: int) -> None:
        """Writes raise ``OSError(ENOSPC)`` once `after_bytes` more
        bytes have been accepted through this wrapper."""
        with self._flock:
            self._enospc_after = self._bytes_through + int(after_bytes)

    # ------------------------------------------------------- injection

    def _on_fail_device(self, key: str) -> bool:
        """Per-stripe-device scoping: does `key`'s stripe placement
        start on the armed device? True when no device scope is set."""
        dev = self._fail_device
        if dev is None:
            return True
        b = self.inner
        while b is not None:
            if hasattr(b, "_device") and hasattr(b, "directories"):
                return b._device(key, 0) == dev
            b = getattr(b, "inner", None)
        return True  # no stripe inside: scope is vacuous

    @staticmethod
    def _fresh(exc: BaseException) -> BaseException:
        # fresh instance per injection: concurrent store workers must
        # not share one exception object (each raise rewrites its
        # __traceback__, corrupting the sibling's surfaced error)
        try:
            return type(exc)(*exc.args)
        except TypeError:            # exotic ctor: fall back to sharing
            return exc

    def _maybe_fail_write(self, key: str, nbytes: int) -> None:
        exc: Optional[BaseException] = None
        with self._flock:
            if (self._fail_writes > 0
                    and (self._fail_key_substr is None
                         or self._fail_key_substr in key)
                    and self._on_fail_device(key)):
                self._fail_writes -= 1
                self.injected["write_failures"] += 1
                exc = self._write_exc or OSError(
                    f"injected write failure for {key!r}")
            elif (self._enospc_after is not None
                    and self._bytes_through >= self._enospc_after):
                self.injected["enospc_failures"] += 1
                exc = OSError(errno.ENOSPC,
                              f"injected ENOSPC for {key!r}")
            elif (self._intermittent_rate > 0.0
                    and self._rng.random() < self._intermittent_rate):
                self.injected["intermittent_failures"] += 1
                exc = self._intermittent_exc or OSError(
                    errno.EIO, f"injected intermittent failure for "
                    f"{key!r}")
            else:
                self._bytes_through += nbytes
                return
        raise self._fresh(exc)

    def _maybe_fail_read(self, key: str) -> None:
        with self._flock:
            if (self._fail_reads <= 0
                    or (self._read_key_substr is not None
                        and self._read_key_substr not in key)
                    or not self._on_fail_device(key)):
                return
            self._fail_reads -= 1
            self.injected["read_failures"] += 1
            exc = self._read_exc or OSError(
                errno.EIO, f"injected read failure for {key!r}")
        raise self._fresh(exc)

    def _shortfall(self) -> int:
        with self._flock:
            if self._short_reads <= 0:
                return 0
            self._short_reads -= 1
            self.injected["short_reads"] += 1
            return self._short_by

    # ------------------------------------------------------ delegation

    def _write(self, key: str, data: bytes) -> None:
        if self.write_delay:
            time.sleep(self.write_delay)
        self._maybe_fail_write(key, len(data))
        self.inner.write(key, data)

    def _write_parts(self, key: str, parts: List[memoryview]) -> None:
        if self.write_delay:
            time.sleep(self.write_delay)
        self._maybe_fail_write(key, sum(len(p) for p in parts))
        self.inner.write_parts(key, parts)

    def _read(self, key: str) -> bytes:
        if self.read_delay:
            time.sleep(self.read_delay)
        self._maybe_fail_read(key)
        data = self.inner.read(key)
        cut = self._shortfall()
        return data[:max(0, len(data) - cut)] if cut else data

    def _readinto(self, key: str, buf: memoryview) -> int:
        if self.read_delay:
            time.sleep(self.read_delay)
        self._maybe_fail_read(key)
        n = len(self.inner.readinto(key, buf))
        cut = self._shortfall()
        return max(0, n - cut) if cut else n

    def _size(self, key: str) -> Optional[int]:
        return self.inner.size(key)

    def _delete(self, key: str) -> None:
        self.inner.delete(key)

    def keys(self) -> List[str]:
        return self.inner.keys()

    def flush(self) -> None:
        self.inner.flush()

    def tier_bandwidths(self):
        return self.inner.tier_bandwidths()

    def close(self) -> None:
        self.inner.close()
        super().close()
