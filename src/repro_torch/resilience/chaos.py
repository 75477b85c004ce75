"""ChaosHarness — script faults against a live backend stack, a copy of
the JAX package's `repro/resilience/chaos.py`.

The chaos tests (and the CI chaos job) need to make a real, running
training session experience a dying SSD: a stripe device that starts
hard-failing mid-run, a flaky controller that drops a fraction of
writes, reads that raise, a filesystem that fills up. The primitives
live in `FaultInjectingBackend` (arming) and `StripedBackend` (per-
device error seams); this harness finds them inside an arbitrarily
nested backend chain and exposes scenario-level verbs on top.
"""
from __future__ import annotations

import errno
from typing import Dict, Iterator, Optional

from repro_torch import obs


def unwrap_chain(backend) -> Iterator[object]:
    """Yield ``backend`` and every backend reachable through the
    standard wrapper attributes (``inner``, ``upper``, ``lower``)."""
    seen = set()
    stack = [backend]
    while stack:
        b = stack.pop()
        if b is None or id(b) in seen:
            continue
        seen.add(id(b))
        yield b
        for attr in ("inner", "upper", "lower"):
            nxt = getattr(b, attr, None)
            if nxt is not None and hasattr(nxt, "kind"):
                stack.append(nxt)


class ChaosHarness:
    """Scenario runner over a backend chain.

    >>> harness = ChaosHarness(spool.backend)
    >>> harness.kill_device(1)          # stripe device 1 is gone
    >>> harness.flaky_writes(0.3, seed=7)
    >>> harness.report()["rebalanced_chunks"]
    """

    def __init__(self, backend) -> None:
        self.backend = backend
        self.fault = None
        self.striped = None
        for b in unwrap_chain(backend):
            kind = getattr(b, "kind", "")
            if kind == "fault" and self.fault is None:
                self.fault = b
            if kind == "striped" and self.striped is None:
                self.striped = b

    # ------------------------------------------------------ scenarios
    def kill_device(self, dev: int,
                    exc: Optional[BaseException] = None) -> None:
        """Hard-fail stripe device ``dev``: every chunk write *and*
        read on it raises, as if the NVMe dropped off the bus."""
        assert self.striped is not None, "no striped backend in chain"
        exc = exc or OSError(errno.EIO, f"chaos: device {dev} died")
        self.striped.set_device_error(dev, exc)
        if obs.is_enabled():
            obs.instant("chaos.kill_device", cat="resilience", dev=dev)

    def heal_device(self, dev: int) -> None:
        assert self.striped is not None, "no striped backend in chain"
        self.striped.clear_device_error(dev)
        if obs.is_enabled():
            obs.instant("chaos.heal_device", cat="resilience", dev=dev)

    def flaky_writes(self, rate: float, seed: int = 0,
                     exc: Optional[BaseException] = None) -> None:
        """Each write through the fault wrapper fails with probability
        ``rate`` (seeded RNG → reproducible chaos)."""
        assert self.fault is not None, "no fault backend in chain"
        self.fault.arm_intermittent(rate, seed=seed, exc=exc)

    def raising_reads(self, n: int, *, key_substr: Optional[str] = None,
                      exc: Optional[BaseException] = None) -> None:
        assert self.fault is not None, "no fault backend in chain"
        self.fault.arm_read_failures(n, exc=exc, key_substr=key_substr)

    def enospc(self, after_bytes: int) -> None:
        """The device reports ENOSPC once ``after_bytes`` more bytes
        have been written through the fault wrapper."""
        assert self.fault is not None, "no fault backend in chain"
        self.fault.arm_enospc(after_bytes)

    # ------------------------------------------------------ reporting
    def report(self) -> Dict[str, int]:
        """Aggregate injected-fault and recovery counters across the
        chain — what the chaos tests assert 'each path fired'."""
        out: Dict[str, int] = {}
        if self.fault is not None:
            out.update(self.fault.injected)
        if self.striped is not None:
            out["rebalanced_chunks"] = self.striped.rebalanced_chunks
            out["chunk_write_failures"] = (
                self.striped.chunk_write_failures)
            out["devices_down"] = sum(self.striped.devices_down())
        return out
