"""The port's cache manager (`repro_torch.cache`: class-aware placement
over bounded host RAM and an SSD tier, promotion, failing-SSD fallback,
`plan_residency`) and its fault-injection paths through the spool, held
against the JAX package: the cases of tests/test_cache_manager.py and
tests/test_spool_faults.py, each run over both packages (the port's
spool takes torch tensors; its non-consuming fetch is a second
`fetch`)."""
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.cache as jcache  # noqa: E402
import repro.core.adaptive as jadaptive  # noqa: E402
import repro.core.policies as jpolicies  # noqa: E402
import repro.core.spool as jspool  # noqa: E402
import repro.io as jio  # noqa: E402
import repro_torch.cache as tcache  # noqa: E402
import repro_torch.core.adaptive as tadaptive  # noqa: E402
import repro_torch.core.policies as tpolicies  # noqa: E402
import repro_torch.core.spool as tspool  # noqa: E402
import repro_torch.io as tio  # noqa: E402

MIN_OFF = 4


def _pkg(name):
    cache, adaptive, policies, spool, io = (
        (jcache, jadaptive, jpolicies, jspool, jio) if name == "jax" else
        (tcache, tadaptive, tpolicies, tspool, tio))
    ns = types.SimpleNamespace(
        leaf=(lambda a: a) if name == "jax" else torch.from_numpy,
        peek=((lambda tx, s: tx.peek(s)) if name == "jax" else
              (lambda tx, s: tx.fetch(s))),
        ModuleProfile=adaptive.ModuleProfile,
        AdaptivePolicy=policies.AdaptivePolicy,
        ActivationSpool=spool.ActivationSpool)
    for n in ("CacheConfig", "CacheManager", "PlacementEngine",
              "plan_residency", "reuse_horizon"):
        setattr(ns, n, getattr(cache, n))
    for n in ("BACKENDS", "AioBackend", "FaultInjectingBackend",
              "FilesystemBackend", "HostMemoryBackend",
              "backend_from_spec"):
        setattr(ns, n, getattr(io, n))
    return ns


@pytest.fixture(params=["jax", "torch"])
def P(request):
    return _pkg(request.param)


def _tree(P, rng, n=4096):
    return {"a": P.leaf(rng.normal(size=(n,)).astype(np.float32)),
            "b": P.leaf(rng.normal(size=(n, 2)).astype(np.float32))}


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# ================================================ the cache manager

KB = 1 << 10


def _blob(rng, n=6 * KB):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _mgr(P, lower=None, bound=16 * KB, **cfg_kw):
    cfg_kw.setdefault("host_bound_bytes", bound)
    return P.CacheManager(lower if lower is not None
                        else P.HostMemoryBackend(),
                        config=P.CacheConfig(**cfg_kw).validate())


# ------------------------------------------------------------ registry

def test_managed_registered_and_spec_constructible(P):
    assert "managed" in P.BACKENDS
    bk = P.backend_from_spec("managed:16kb,mem")
    assert isinstance(bk, P.CacheManager)
    assert isinstance(bk.lower, P.HostMemoryBackend)
    assert bk.capacity_bytes == 16 * KB
    bk.write("k", b"x" * KB)
    assert bk.read("k") == b"x" * KB
    bk.close()


def test_classification_longest_prefix_wins(P):
    m = _mgr(P)
    assert m.classify("mb0_s1") == "activation"
    assert m.classify("opt3_moments") == "opt_state"
    assert m.classify("kv12_p4") == "kv_page"
    m.register_class("special", prefix="opt_special", distance=9.0)
    assert m.classify("opt_special_x") == "special"
    assert m.classify("opt3_moments") == "opt_state"
    m.register_class("special")          # idempotent re-registration
    assert m.classify("opt_special_x") == "special"
    m.close()


# ------------------------------------------- placement and accounting

def test_bound_respected_and_accounting_exact(P):
    """A healthy SSD tier: the host-RAM bound holds, every byte is on
    exactly one tier, and the per-tier sums reconcile with the blobs."""
    rng = np.random.default_rng(0)
    m = _mgr(P, bound=16 * KB, promote=False)
    blobs = {f"mb0_s{i}": _blob(rng) for i in range(5)}
    for k, b in blobs.items():
        m.write(k, b)
    assert m.resident_bytes <= m.capacity_bytes
    upper, lowered = m.engine.tier_items()
    assert set(upper) | set(lowered) == set(blobs)
    assert not set(upper) & set(lowered)
    total = sum(len(b) for b in blobs.values())
    assert sum(upper.values()) + sum(lowered.values()) == total
    st = m.cache_stats()
    assert st["host_bytes"] + st["ssd_bytes"] == total
    assert st["host_peak_bytes"] <= m.capacity_bytes
    for k, b in blobs.items():           # every blob readable bitwise
        assert m.read(k) == b
    m.close()


def test_victim_is_farthest_reuse_class(P):
    """Belady's choice by class: the kv page (distance 3x) is demoted
    before either activation, regardless of store order."""
    rng = np.random.default_rng(1)
    m = _mgr(P, bound=16 * KB, promote=False)
    m.write("mb0_s0", _blob(rng))
    m.write("kv7_p0", _blob(rng))
    m.write("mb0_s1", _blob(rng))        # overflow: one victim needed
    res = m.residency()
    assert res["ssd"] == {"kv_page": 6 * KB}
    assert res["host-ram"] == {"activation": 12 * KB}
    m.close()


def test_hinted_keys_survive_eviction(P):
    """A key on the hinted reuse horizon is never the victim — the
    next-farthest unhinted blob is demoted instead."""
    rng = np.random.default_rng(2)
    m = _mgr(P, bound=16 * KB, promote=False)
    m.write("mb0_s0", _blob(rng))
    m.write("kv7_p0", _blob(rng))
    m.hint_next(["kv7_p0"])              # imminent refill
    m.write("mb0_s1", _blob(rng))
    upper, lowered = m.engine.tier_items()
    assert "kv7_p0" in upper
    assert "mb0_s0" in lowered           # the unhinted activation paid
    m.close()


def test_hint_promotes_lowered_blob_back_to_host(P):
    """hint_next on a lowered key triggers background promotion once
    the slow (measured) lower tier prices the move as a win and the
    budget has headroom."""
    rng = np.random.default_rng(3)
    slow = P.FaultInjectingBackend(P.HostMemoryBackend(), write_delay=0.02)
    m = _mgr(P, lower=slow, bound=16 * KB, promote_depth=2)
    blobs = {f"mb0_s{i}": _blob(rng) for i in range(4)}
    for k, b in blobs.items():
        m.write(k, b)
    _, lowered = m.engine.tier_items()
    assert lowered                       # something spilled
    victim = next(iter(lowered))
    for k in list(blobs):                # free headroom for promotion
        if k != victim:
            m.delete(k)
    m.hint_next([victim])
    deadline = time.monotonic() + 5.0
    while m.engine.promotions == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert m.engine.promotions == 1
    assert m.engine.bytes_promoted == len(blobs[victim])
    upper, lowered = m.engine.tier_items()
    assert victim in upper and not lowered
    assert m.read(victim) == blobs[victim]
    m.close()


def test_measured_distances_rerank_victims(P):
    """P.AdaptivePolicy's profile feed: once activations measure FARTHER
    reuse than kv pages, the activation becomes the victim."""
    rng = np.random.default_rng(4)
    m = _mgr(P, bound=16 * KB, promote=False)
    pol = P.AdaptivePolicy()
    pol.attach_cache_manager(m)
    pol.on_profile([P.ModuleProfile("l0", 6 * KB, 2.0),
                    P.ModuleProfile("l1", 6 * KB, 2.0)], 1e9)
    # t_step = 4s * (1 + bwd_factor): activation 0.5x, kv 3x of that —
    # kv still farther; now flip the table by hand like a serving-side
    # recency feed would
    assert m._distances["kv_page"] > m._distances["activation"]
    m.hint_class_distance("kv_page", 0.1)
    m.write("mb0_s0", _blob(rng))
    m.write("kv7_p0", _blob(rng))
    m.write("mb0_s1", _blob(rng))
    _, lowered = m.engine.tier_items()
    assert set(lowered) == {"mb0_s0"}
    m.close()


# ------------------------------------- failing SSD tier (the satellite)

def test_failing_ssd_falls_back_to_host_residency(P):
    """Every demotion into a dead SSD tier must re-admit the blob to
    host RAM: no data loss, nothing on the SSD, accounting exact."""
    rng = np.random.default_rng(5)
    ssd = P.FaultInjectingBackend(
        P.HostMemoryBackend(), fail_writes=10_000,
        write_exc=OSError(5, "Input/output error"))
    m = _mgr(P, lower=ssd, bound=16 * KB, promote=False)
    blobs = {f"mb0_s{i}": _blob(rng) for i in range(5)}
    for k, b in blobs.items():
        m.write(k, b)
    total = sum(len(b) for b in blobs.values())
    # all five blobs are host-resident (over budget — degraded mode)
    upper, lowered = m.engine.tier_items()
    assert set(upper) == set(blobs) and not lowered
    assert sum(upper.values()) == total == m.resident_bytes
    assert m.peak_host_bytes >= total
    st = m.cache_stats()
    assert st["fallbacks"] >= 3          # the three overflow victims
    assert st["bytes_fallback"] >= 3 * 6 * KB
    assert st["ssd_bytes"] == 0
    assert len(ssd.inner._blobs) == 0    # nothing ever landed on SSD
    for k, b in blobs.items():
        assert m.read(k) == b
    m.close()


def test_transient_ssd_failure_exact_fallback_accounting(P):
    """Exactly one armed write failure -> exactly one fallback, with
    byte-exact counters, and later demotions succeed again."""
    rng = np.random.default_rng(6)
    ssd = P.FaultInjectingBackend(P.HostMemoryBackend())
    m = _mgr(P, lower=ssd, bound=16 * KB, promote=False)
    m.write("mb0_s0", _blob(rng))
    m.write("mb0_s1", _blob(rng))
    ssd.arm_write_failures(1)
    m.write("mb0_s2", _blob(rng))        # victim's demotion fails
    assert m.engine.fallbacks == 1
    assert m.engine.bytes_fallback == 6 * KB
    assert m.engine.evictions == 0
    m.write("mb0_s3", _blob(rng))        # SSD healthy again
    _, lowered = m.engine.tier_items()
    assert m.engine.evictions >= 1 and lowered
    assert ssd.injected["write_failures"] == 1
    m.close()


def test_oversize_blob_with_failing_ssd_stays_in_ram(P):
    """An over-budget blob normally bypasses RAM straight to SSD; with
    the SSD down it is held in RAM instead of lost."""
    rng = np.random.default_rng(7)
    ssd = P.FaultInjectingBackend(P.HostMemoryBackend(), fail_writes=1)
    m = _mgr(P, lower=ssd, bound=8 * KB, promote=False)
    big = _blob(rng, 32 * KB)
    m.write("mb0_s0", big)
    assert m.engine.fallbacks == 1
    assert m.engine.bytes_fallback == 32 * KB
    assert m.resident_bytes == 32 * KB   # over budget, by design
    assert m.read("mb0_s0") == big
    m.delete("mb0_s0")
    assert m.resident_bytes == 0
    m.close()


def test_spool_leases_drop_cleanly_over_failing_ssd(P, tmp_path):
    """The full lease contract through the manager with a dead SSD
    tier: residuals offload, fetch back bitwise, and the transaction's
    close leaves neither spool records nor manager residency behind."""
    rng = np.random.default_rng(8)
    ssd = P.FaultInjectingBackend(
        P.FilesystemBackend(str(tmp_path / "ssd")), fail_writes=10_000)
    m = _mgr(P, lower=ssd, bound=8 * KB, promote=False)
    spool = P.ActivationSpool(m, min_offload_elements=4,
                            store_threads=1, load_threads=1)
    trees = {s: {"r": P.leaf(rng.normal(size=(2048,)).astype(np.float32))}
             for s in range(3)}
    with spool.step("mb0") as tx:
        for s, t in trees.items():
            tx.offload(s, t)
        spool.wait_io()
        for s in reversed(range(3)):     # backward-order fetch
            out = tx.fetch(s)
            np.testing.assert_array_equal(out["r"], trees[s]["r"])
            tx.drop(s)
    assert not spool._records            # lease fully dropped
    upper, lowered = m.engine.tier_items()
    assert not upper and not lowered     # manager accounting empty
    assert m.resident_bytes == 0
    spool.close()


# --------------------------------------------------- metrics / planning

def test_metrics_delta_diffs_monotonic_counters(P):
    rng = np.random.default_rng(9)
    m = _mgr(P, bound=16 * KB, promote=False)
    for i in range(3):
        m.write(f"mb0_s{i}", _blob(rng))
    block, snap = m.metrics_delta(None)
    assert block["evictions"] == m.engine.evictions >= 1
    ev0 = m.engine.evictions
    m.write("mb0_s3", _blob(rng))
    m.read("mb0_s3")
    block, _ = m.metrics_delta(snap)
    assert block["evictions"] == m.engine.evictions - ev0
    assert block["host_hits"] == 1
    # gauges pass through, not diffed
    assert block["host_bytes"] == m.engine.resident_bytes
    assert block["host_bound_bytes"] == 16 * KB
    m.close()


def test_plan_residency_fills_host_by_reuse_distance(P):
    plan = P.plan_residency(
        {"activation": 6, "opt_state": 6, "kv_page": 6},
        host_bound_bytes=10)
    assert plan["activation"] == {"host_ram_bytes": 6, "ssd_bytes": 0}
    assert plan["opt_state"] == {"host_ram_bytes": 4, "ssd_bytes": 2}
    assert plan["kv_page"] == {"host_ram_bytes": 0, "ssd_bytes": 6}
    zero = P.plan_residency({"activation": 5}, host_bound_bytes=0)
    assert zero["activation"] == {"host_ram_bytes": 0, "ssd_bytes": 5}
    flipped = P.plan_residency(
        {"activation": 6, "kv_page": 6}, host_bound_bytes=6,
        distances={"kv_page": 0.1})
    assert flipped["kv_page"]["host_ram_bytes"] == 6
    assert flipped["activation"]["ssd_bytes"] == 6


def test_reuse_horizon_prefix_semantics(P):
    assert P.reuse_horizon(range(3, -1, -1)) == [3]
    assert P.reuse_horizon(range(3, -1, -1), depth=2) == [3, 2]
    assert P.reuse_horizon(range(1, -1, -1), depth=5) == [1, 0]
    assert P.reuse_horizon([], depth=3) == []
    assert P.reuse_horizon(["a", "b"], depth=0) == []


def test_placement_engine_fifo_default_matches_tiered(P):
    """Without a victim_fn the engine is the legacy tiered policy:
    FIFO front-pop, no class awareness."""
    eng = P.PlacementEngine(P.HostMemoryBackend(), P.HostMemoryBackend(),
                          capacity_bytes=2 * KB)
    eng.put("a", KB, lambda t: t.write("a", b"x" * KB))
    eng.put("b", KB, lambda t: t.write("b", b"y" * KB))
    eng.put("c", KB, lambda t: t.write("c", b"z" * KB))
    upper, lowered = eng.tier_items()
    assert set(lowered) == {"a"} and list(upper) == ["b", "c"]
    assert eng.read("a") == b"x" * KB


# ============================================ faults through the spool

def _tree_bytes(tree):
    return sum(a.nbytes for a in tree.values())


def _spool(P, backend, **kw):
    kw.setdefault("min_offload_elements", MIN_OFF)
    kw.setdefault("store_threads", 1)
    kw.setdefault("load_threads", 1)
    return P.ActivationSpool(backend, **kw)


# ------------------------------------------------------------ factory

def test_fault_backend_registered_and_spec_constructible(P):
    assert "fault" in P.BACKENDS
    bk = P.backend_from_spec("fault@2:mem")
    assert isinstance(bk, P.FaultInjectingBackend)
    assert isinstance(bk.inner, P.HostMemoryBackend)
    assert bk.zero_copy_read            # mirrors the inner backend
    with pytest.raises(OSError):
        bk.write("k", b"x" * 64)
    with pytest.raises(OSError):
        bk.write("k", b"x" * 64)
    bk.write("k", b"x" * 64)            # third write succeeds
    assert bk.injected["write_failures"] == 2
    assert bk.read("k") == b"x" * 64
    bk.close()


def test_fault_spec_wraps_fs_and_owns_tmpdir(P, tmp_path):
    bk = P.backend_from_spec(f"fault:fs:{tmp_path}/inner")
    assert isinstance(bk.inner, P.FilesystemBackend)
    assert bk.directory == f"{tmp_path}/inner"
    bk.write("k", b"payload")
    assert bk.read("k") == b"payload"
    bk.close()


# ----------------------------------------- failed-store recovery paths

def test_failed_store_then_fetch_forwards_in_memory(P):
    """A store that dies on the device (ENOSPC-style) must not lose the
    step: fetch forwards the still-referenced arrays instead of chasing
    a blob that never landed."""
    bk = P.FaultInjectingBackend(P.HostMemoryBackend(), fail_writes=1,
                               write_exc=OSError(28, "No space left"))
    spool = _spool(P, bk)
    rng = np.random.default_rng(0)
    tree = _tree(P, rng)
    with spool.step("mb0") as tx:
        tx.offload(0, tree)
        spool.wait_io()                  # store failed; arrays resident
        out = tx.fetch(0)
        _assert_tree_equal(tree, out)
        tx.drop(0)                       # delete of unwritten key: no-op
    assert spool.stats.bytes_forwarded == _tree_bytes(tree)
    assert bk.injected["write_failures"] == 1
    assert bk.inner.stats.num_writes == 0
    assert not spool._records
    spool.close()


def test_failed_store_peek_then_fetch_counts_one_forwarding(P):
    """Peek-then-fetch of one failed store is ONE forwarding event (the
    fwd_counted regression), even through the injector. Three armed
    failures defeat the default 3-attempt retry, so the store really
    fails (a single transient failure is ridden out since resilience)."""
    bk = P.FaultInjectingBackend(P.HostMemoryBackend(), fail_writes=3)
    spool = _spool(P, bk)
    rng = np.random.default_rng(1)
    tree = _tree(P, rng)
    with spool.step("mb0") as tx:
        tx.offload(0, tree)
        spool.wait_io()
        _assert_tree_equal(tree, P.peek(tx, 0))
        _assert_tree_equal(tree, tx.fetch(0))
        tx.drop(0)
    assert spool.stats.bytes_forwarded == _tree_bytes(tree)
    assert spool.stats.store_retries == 2    # attempts 2 and 3
    spool.close()


def test_lease_dropped_on_exception_mid_step(P):
    """An exception between offload and fetch must not strand records:
    the transaction's close() drops everything, including blobs whose
    (delayed) store is still in flight when the step aborts."""
    bk = P.FaultInjectingBackend(P.HostMemoryBackend(), write_delay=0.2)
    spool = _spool(P, bk)
    rng = np.random.default_rng(2)
    with pytest.raises(RuntimeError, match="step exploded"):
        with spool.step("mb0") as tx:
            tx.offload(0, _tree(P, rng))
            tx.offload(1, _tree(P, rng))
            raise RuntimeError("step exploded")
    spool.wait_io()
    assert not spool._records            # every record dropped
    # an orphaned in-flight write is deleted when it lands; nothing may
    # survive on the backend
    assert len(bk.inner._blobs) == 0
    spool.close()
    # the lease itself was released: the step id is reusable
    spool2 = _spool(P, P.FaultInjectingBackend(P.HostMemoryBackend()))
    with spool2.step("mb0"):
        pass
    spool2.close()


def test_short_read_surfaces_error_and_releases_pool(P, tmp_path):
    """A truncated blob (torn write / bad device) must surface as a
    load error at fetch — not a hang, not a corrupt tree — and the
    pooled load buffer must go back to the pool."""
    bk = P.FaultInjectingBackend(P.FilesystemBackend(str(tmp_path)),
                               short_reads=1, short_by=8)
    spool = _spool(P, bk)
    rng = np.random.default_rng(3)
    tree = _tree(P, rng)
    with spool.step("mb0") as tx:
        tx.offload(0, tree)
        spool.wait_io()                  # store landed; memory released
        with pytest.raises(RuntimeError, match="spool load failed"):
            tx.fetch(0)
        tx.drop(0)
    assert bk.injected["short_reads"] == 1
    # the failed load's pool lease was released, not leaked
    pstats = spool.pool.stats()
    assert pstats["free_bytes"] == pstats["bytes_allocated"]
    # the spool stays usable: a healthy record round-trips after the
    # failure (the worker survived the poisoned job)
    with spool.step("mb1") as tx:
        tx.offload(0, tree)
        spool.wait_io()
        _assert_tree_equal(tree, tx.fetch(0))
        tx.drop(0)
    spool.close()


def test_delayed_store_completion_forwarding_and_cancel(P):
    """Slow stores widen the forwarding windows: a fetch racing a
    QUEUED store cancels it, one racing a RUNNING store forwards and
    lets the write land — counters must account for both exactly."""
    bk = P.FaultInjectingBackend(P.HostMemoryBackend(), write_delay=0.3)
    spool = _spool(P, bk)                   # store_threads=1: 2nd job queues
    rng = np.random.default_rng(4)
    t0, t1 = _tree(P, rng), _tree(P, rng)
    with spool.step("mb0") as tx:
        tx.offload(0, t0)                # worker picks up, sleeps
        time.sleep(0.05)                 # let the worker reach RUNNING
        tx.offload(1, t1)                # still QUEUED behind it
        _assert_tree_equal(t1, tx.fetch(1))   # queued -> cancel+forward
        _assert_tree_equal(t0, tx.fetch(0))   # running -> forward
        tx.drop(0)
        tx.drop(1)
    spool.wait_io()
    assert spool.stats.bytes_forwarded == _tree_bytes(t0) + _tree_bytes(t1)
    assert spool.stats.stores_canceled >= 1
    assert spool.stats.num_stores + spool.stats.stores_canceled == 2
    spool.close()


# ------------------------------------------------- aio sibling waits

@pytest.mark.skipif(not hasattr(os, "pwritev"), reason="needs pwritev")
def test_aio_failed_segment_waits_for_sibling_writes(P, tmp_path,
                                                     monkeypatch):
    """When one of a blob's concurrent segments fails, the aio backend
    must wait for every sibling pwritev to finish before closing the
    fd — closing early would let the OS recycle the descriptor under a
    still-running write (cross-blob corruption)."""
    backend = P.AioBackend(str(tmp_path), queue_depth=4, direct=False)
    events = []
    fds = set()
    lock = threading.Lock()
    real_pwritev, real_close = os.pwritev, os.close

    def slow_pwritev(fd, bufs, offset):
        with lock:
            fds.add(fd)
        if offset == 0:
            raise OSError(5, "injected segment failure")
        time.sleep(0.25)
        n = real_pwritev(fd, bufs, offset)
        with lock:
            events.append(("pwritev_done", fd, time.monotonic()))
        return n

    def traced_close(fd):
        with lock:
            if fd in fds:
                events.append(("close", fd, time.monotonic()))
        return real_close(fd)

    monkeypatch.setattr(os, "pwritev", slow_pwritev)
    monkeypatch.setattr(os, "close", traced_close)
    payload = os.urandom(1 << 20)        # 4 x 256 KiB segments
    with pytest.raises(OSError):
        backend.write("blob", payload)
    monkeypatch.undo()
    closes = {fd: t for ev, fd, t in events if ev == "close"}
    done = [(fd, t) for ev, fd, t in events if ev == "pwritev_done"]
    assert done, "sibling segments never ran"
    for fd, t in done:
        assert fd in closes, "fd never closed"
        assert t <= closes[fd], \
            "fd closed while a sibling pwritev was still running"
    backend.close()


def test_fault_injection_through_spool_store_path_keeps_worker_alive(P):
    """Armed at runtime: a burst of failures mid-training must not kill
    the store workers — later steps keep spooling normally."""
    bk = P.FaultInjectingBackend(P.HostMemoryBackend())
    spool = _spool(P, bk)
    rng = np.random.default_rng(5)
    ok = _tree(P, rng)
    with spool.step("s0") as tx:
        tx.offload(0, ok)
        spool.wait_io()
        _assert_tree_equal(ok, tx.fetch(0))
        tx.drop(0)
    bk.arm_write_failures(3, key_substr="s1")  # defeats 3-try retry
    bad = _tree(P, rng)
    with spool.step("s1") as tx:
        tx.offload(0, bad)
        spool.wait_io()
        _assert_tree_equal(bad, tx.fetch(0))   # forwarded
        tx.drop(0)
    with spool.step("s2") as tx:               # healthy again
        tx.offload(0, ok)
        spool.wait_io()
        _assert_tree_equal(ok, tx.fetch(0))
        tx.drop(0)
    assert bk.injected["write_failures"] == 3
    assert spool.stats.store_retries == 2
    assert spool.stats.num_stores == 2
    spool.close()


# ================================= a managed session on the CPU

def test_a_managed_session_demotes_and_stays_bitwise(tmp_path):
    """Training over a managed backend whose host bound holds two of a
    step's blobs: blobs are demoted as they are stored, backward hints
    each before its load, the bound holds, and losses and parameters are
    bitwise equal to keep. Whether a hinted blob is promoted back is a
    race with its own load, as in the JAX manager (promotion itself is
    held by `test_hint_promotes_lowered_blob_back_to_host`)."""
    from repro_torch.configs import SpoolIoConfig
    from repro_torch.core.policies import KeepPolicy, SpoolPolicy
    from repro_torch.core.tree import tree_flatten
    from repro_torch.session import TrainSession

    class Drained(SpoolPolicy):
        spool = None

        def should_offload(self, stage, profile=None):
            if profile is not None and profile.name == "head":
                self.spool.wait_io()
            return True

    def run(policy, io, steps=2):
        with TrainSession("small-gpt", device="cpu", policy=policy, io=io,
                          batch_size=2, seq_len=32, seed=0,
                          min_offload_elements=0, attn_impl="torch") as s:
            if isinstance(policy, Drained):
                policy.spool = s.spool
            reps = s.run(steps).reports
            params = [t.clone() for t in tree_flatten(s.params)[0]]
        return reps, params

    keep, pk = run(KeepPolicy(), SpoolIoConfig(backend="mem"))
    reps, ps = run(Drained(), SpoolIoConfig(
        backend=f"managed:3mb,fs:{tmp_path}/ssd"))
    rows = [r.to_metrics() for r in reps]
    assert [r.loss for r in reps] == [r.loss for r in keep]
    assert all(torch.equal(a, b) for a, b in zip(ps, pk))
    assert sum(r["cache_evictions"] for r in rows) > 0
    assert sum(r["cache_hints"] for r in rows) > 0
    assert all(r["cache_host_peak_bytes"] <= r["cache_host_bound_bytes"]
               for r in rows)
