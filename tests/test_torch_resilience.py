"""The port's resilience layer (`repro_torch.resilience`, the fault
injector, the spool's retries, the striped backend's rebalancing, the
health-driven re-plan) held against the JAX package's: the cases of
tests/test_resilience.py run over both packages where the API is the
same, then the port's staged engine end to end on small-gpt on the CPU:
a fetch that fails for good recomputes its stage, and the chaos scenario
(a stripe device dies mid-run while reads raise) fires retry, recompute
fallback and rebalance and stays bitwise equal to keep; its metrics rows
carry the JAX staged session's `cache_*` and `resilience_*` keys."""
import errno
import json
import os
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.core.adaptive as jadaptive  # noqa: E402
import repro.core.policies as jpolicies  # noqa: E402
import repro.io as jio  # noqa: E402
import repro.io.backend as jbackend  # noqa: E402
import repro.resilience as jres  # noqa: E402
import repro_torch.core.adaptive as tadaptive  # noqa: E402
import repro_torch.core.policies as tpolicies  # noqa: E402
import repro_torch.io as tio  # noqa: E402
import repro_torch.io.backend as tbackend  # noqa: E402
import repro_torch.resilience as tres  # noqa: E402
from repro.core.spool import ActivationSpool as JSpool  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import SpoolIoConfig  # noqa: E402
from repro_torch.core.policies import KeepPolicy, SpoolPolicy  # noqa: E402
from repro_torch.core.spool import ActivationSpool as TSpool  # noqa: E402
from repro_torch.core.spool import SpoolLoadError  # noqa: E402
from repro_torch.session import TrainSession  # noqa: E402

MIN_OFF = 4


def _pkg(name):
    if name == "jax":
        return types.SimpleNamespace(
            io=jio, backend=jbackend, res=jres, Spool=JSpool,
            adaptive=jadaptive, policies=jpolicies, leaf=lambda a: a)
    return types.SimpleNamespace(
        io=tio, backend=tbackend, res=tres, Spool=TSpool,
        adaptive=tadaptive, policies=tpolicies, leaf=torch.from_numpy)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _pkg(request.param)


def _tree(pkg, rng, n=4096):
    return {"a": pkg.leaf(rng.normal(size=(n,)).astype(np.float32)),
            "b": pkg.leaf(rng.normal(size=(n, 2)).astype(np.float32))}


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _spool(pkg, backend, **kw):
    kw.setdefault("min_offload_elements", MIN_OFF)
    kw.setdefault("store_threads", 1)
    kw.setdefault("load_threads", 1)
    return pkg.Spool(backend, **kw)


def _fast_retry(pkg, **kw):
    kw.setdefault("backoff_s", 1e-4)
    kw.setdefault("backoff_max_s", 1e-3)
    return pkg.res.RetryPolicy(**kw)


# =================================================== taxonomy + policy

def test_error_taxonomy(pkg):
    c = pkg.backend.classify_io_error
    assert c(OSError(errno.EIO, "io")) == "transient"
    assert c(OSError(errno.EAGAIN, "again")) == "transient"
    assert c(TimeoutError()) == "transient"
    assert c(OSError(errno.ENOSPC, "full")) == "fatal"
    assert c(OSError(errno.ENODEV, "gone")) == "fatal"
    assert c(FileNotFoundError("x")) == "fatal"
    assert c(ValueError("bad serde")) == "fatal"
    assert c(OSError("mystery")) == "transient"


def test_retry_policy_backoff_schedule(pkg):
    p = pkg.res.RetryPolicy(max_attempts=4, backoff_s=0.01,
                            backoff_factor=2.0, backoff_max_s=0.025)
    assert [p.delay(a) for a in (1, 2, 3)] == [0.01, 0.02, 0.025]
    with pytest.raises(AssertionError):
        pkg.res.RetryPolicy(max_attempts=0).validate()


def test_backend_health_transitions_and_events(pkg):
    h = pkg.res.BackendHealth("t", fail_threshold=2, min_samples=2,
                              degrade_latency_ratio=2.0)
    events = []
    h.subscribe(events.append)
    exc = OSError(5, "boom")
    h.record_failure("write", exc)
    assert h.status == "healthy"
    h.record_failure("write", exc)
    assert h.status == "failing"
    h.record_success("write", 0.001)
    assert h.status == "healthy"
    assert [e.kind for e in events] == ["failing", "recovered"]
    for _ in range(2):
        h.record_success("read", 0.001)
    for _ in range(6):
        h.record_success("read", 0.1)
    assert h.status == "degraded"
    assert any(e.kind == "degraded" and e.op == "read" for e in events)
    snap = h.snapshot()
    assert snap["health"] == 1 and snap["read_latency_ratio"] > 2.0


def test_health_subscriber_exceptions_are_swallowed(pkg):
    h = pkg.res.BackendHealth("t", fail_threshold=1)
    h.subscribe(lambda e: (_ for _ in ()).throw(RuntimeError("bad sub")))
    h.record_failure("write", OSError(5, "x"))
    assert h.status == "failing"


def test_port_health_transitions_under_tracing():
    """Every transition emits its instant and the health gauge while a
    tracer is on (the JAX package's gauge call also passes backend=,
    which the tracer's gauge does not take)."""
    owned = not obs.is_enabled()
    tracer = obs.enable()
    try:
        h = tres.BackendHealth("fs", fail_threshold=1)
        h.record_failure("read", OSError(5, "x"))
        h.record_success("read", 0.001)
        assert h.status == "healthy"
        assert tracer.counters()["resilience.health"] == 0
    finally:
        if owned:
            obs.disable()


# ============================================== spool retry accounting

def test_transient_store_retry_exact_accounting(pkg):
    bk = pkg.io.FaultInjectingBackend(pkg.io.HostMemoryBackend(),
                                      fail_writes=2)
    spool = _spool(pkg, bk, retry=_fast_retry(pkg))
    tree = _tree(pkg, np.random.default_rng(0))
    with spool.step("mb0") as tx:
        tx.offload(0, tree)
        spool.wait_io()
        assert bk.injected["write_failures"] == 2
        assert spool.stats.store_retries == 2
        assert spool.stats.num_stores == 1
        assert bk.inner.stats.num_writes == 1
        _assert_tree_equal(tree, tx.fetch(0))
        tx.drop(0)
    assert spool.stats.bytes_forwarded == 0
    assert spool.health.status == "healthy"
    spool.close()


def test_transient_load_retry_exact_accounting(pkg, tmp_path):
    bk = pkg.io.FaultInjectingBackend(pkg.io.FilesystemBackend(
        str(tmp_path)))
    spool = _spool(pkg, bk, retry=_fast_retry(pkg))
    tree = _tree(pkg, np.random.default_rng(1))
    with spool.step("mb0") as tx:
        tx.offload(0, tree)
        spool.wait_io()
        bk.arm_read_failures(2)
        _assert_tree_equal(tree, tx.fetch(0))
        tx.drop(0)
    assert bk.injected["read_failures"] == 2
    assert spool.stats.load_retries == 2
    spool.close()


def test_exhausted_retries_surface_and_feed_health(pkg):
    bk = pkg.io.FaultInjectingBackend(pkg.io.HostMemoryBackend(),
                                      fail_writes=100)
    spool = _spool(pkg, bk, retry=_fast_retry(pkg, max_attempts=3))
    events = []
    spool.health.subscribe(events.append)
    tree = _tree(pkg, np.random.default_rng(2))
    with spool.step("mb0") as tx:
        tx.offload(0, tree)
        spool.wait_io()
        assert bk.injected["write_failures"] == 3
        assert spool.stats.store_retries == 2
        _assert_tree_equal(tree, tx.fetch(0))        # forwarded, not lost
        tx.drop(0)
    assert spool.health.status == "failing"
    assert any(e.kind == "failing" for e in events)
    spool.close()


def test_fatal_error_not_retried(pkg):
    bk = pkg.io.FaultInjectingBackend(
        pkg.io.HostMemoryBackend(), fail_writes=1,
        write_exc=OSError(28, "No space left on device"))
    spool = _spool(pkg, bk, retry=_fast_retry(pkg))
    with spool.step("mb0") as tx:
        tx.offload(0, _tree(pkg, np.random.default_rng(3)))
        spool.wait_io()
        assert bk.injected["write_failures"] == 1
        assert spool.stats.store_retries == 0
        tx.drop(0)
    spool.close()


# ================================================ fault primitives

def test_intermittent_faults_are_seeded_and_reproducible(pkg):
    def run(seed):
        bk = pkg.io.FaultInjectingBackend(pkg.io.HostMemoryBackend(),
                                          intermittent_rate=0.5,
                                          intermittent_seed=seed)
        outcomes = []
        for i in range(32):
            try:
                bk.write(f"k{i}", b"x" * 16)
                outcomes.append(True)
            except OSError:
                outcomes.append(False)
        n = bk.injected["intermittent_failures"]
        bk.close()
        return outcomes, n
    a, na = run(7)
    b, _ = run(7)
    c, _ = run(8)
    assert a == b and a != c and any(a) and not all(a)
    assert na == a.count(False)


def test_intermittent_schedule_equal_across_packages():
    """One seed, one fault schedule, in either package."""
    runs = []
    for io in (jio, tio):
        bk = io.FaultInjectingBackend(io.HostMemoryBackend(),
                                      intermittent_rate=0.3,
                                      intermittent_seed=11)
        out = []
        for i in range(64):
            try:
                bk.write(f"k{i}", b"x")
                out.append(True)
            except OSError:
                out.append(False)
        runs.append(out)
    assert runs[0] == runs[1]


def test_enospc_after_budget(pkg):
    bk = pkg.io.FaultInjectingBackend(pkg.io.HostMemoryBackend(),
                                      enospc_after_bytes=100)
    bk.write("a", b"x" * 60)
    bk.write("b", b"x" * 60)
    with pytest.raises(OSError) as ei:
        bk.write("c", b"x" * 10)
    assert ei.value.errno == 28
    assert bk.injected["enospc_failures"] == 1
    bk.close()


def test_fault_device_scoping_on_stripe(pkg, tmp_path):
    striped = pkg.io.StripedBackend([str(tmp_path / f"d{i}")
                                     for i in range(2)], chunk_bytes=64)
    bk = pkg.io.FaultInjectingBackend(striped)
    k0 = next(f"k{i}" for i in range(64) if striped._device(f"k{i}", 0) == 0)
    k1 = next(f"k{i}" for i in range(64) if striped._device(f"k{i}", 0) == 1)
    bk.arm_write_failures(100, device=1)
    bk.write(k0, b"x" * 32)
    with pytest.raises(OSError):
        bk.write(k1, b"x" * 32)
    assert bk.injected["write_failures"] == 1
    bk.close()


# =========================================== striped rebalance

def test_striped_rebalance_avoids_dead_device(pkg, tmp_path):
    bk = pkg.io.StripedBackend([str(tmp_path / f"d{i}") for i in range(3)],
                               chunk_bytes=64)
    harness = pkg.res.ChaosHarness(bk)
    payload = os.urandom(64 * 6)
    bk.write("warm", payload)
    harness.kill_device(1)
    for i in range(4):
        key = f"post{i}"
        bk.write(key, payload)
        assert 1 not in bk._placement(key)
        assert bk.read(key) == payload
    assert bk.rebalanced_chunks >= 8
    assert sum(bk.devices_down()) == 1
    per_dev = bk.per_device_write_bytes()
    assert per_dev[1] == len(payload) // 3
    assert sum(per_dev) == len(payload) * 5
    harness.heal_device(1)
    assert sum(bk.devices_down()) == 0
    bk.write("healed", payload)
    assert bk.read("healed") == payload
    assert harness.report()["rebalanced_chunks"] == bk.rebalanced_chunks
    bk.close()


def test_striped_read_of_dead_device_chunk_raises(pkg, tmp_path):
    bk = pkg.io.StripedBackend([str(tmp_path / f"d{i}") for i in range(2)],
                               chunk_bytes=64)
    bk.write("k", os.urandom(64 * 4))
    pkg.res.ChaosHarness(bk).kill_device(0)
    with pytest.raises(OSError):
        bk.read("k")
    bk.close()


def test_striped_write_failures_down_device_at_threshold(pkg, tmp_path,
                                                         monkeypatch):
    bk = pkg.io.StripedBackend([str(tmp_path / f"d{i}") for i in range(2)],
                               chunk_bytes=64, fail_threshold=2)
    real = bk._write_chunk
    fails = {"n": 0}

    def flaky(dev, key, i, views):
        if dev == 0 and fails["n"] < 2:
            fails["n"] += 1
            raise OSError(5, "injected chunk failure")
        return real(dev, key, i, views)

    monkeypatch.setattr(bk, "_write_chunk", flaky)
    k1 = next(f"k{i}" for i in range(64) if bk._device(f"k{i}", 0) == 0)
    k2 = next(f"j{i}" for i in range(64) if bk._device(f"j{i}", 0) == 0)
    bk.write(k1, b"x" * 64)
    assert bk.chunk_write_failures == 1 and not any(bk.devices_down())
    assert bk.rebalanced_chunks == 1
    bk.write(k2, b"z" * 64)
    assert bk.chunk_write_failures == 2 and bk.devices_down()[0]
    assert bk.per_device_write_bytes()[0] == 0
    assert bk.read(k1) == b"x" * 64
    bk.close()


def test_unwrap_chain_walks_wrappers(pkg, tmp_path):
    bk = pkg.io.backend_from_spec(
        f"fault:tiered:1mb,striped:{tmp_path}/a,{tmp_path}/b")
    assert {"fault", "tiered", "striped"} <= {
        b.kind for b in pkg.res.unwrap_chain(bk)}
    h = pkg.res.ChaosHarness(bk)
    assert h.fault is not None and h.striped is not None
    bk.close()


# =================================================== mid-run re-plan

def _profiles(pkg):
    return [pkg.adaptive.ModuleProfile(f"seg0_l{i}", 64 << 20, 0.05)
            for i in range(4)]


def test_adaptive_replan_on_failing_and_recovered(pkg):
    pol = pkg.policies.AdaptivePolicy()
    pol.on_profile(_profiles(pkg), 8e9)
    n0 = sum(pol.plan.offload)
    assert n0 > 0
    h = pkg.res.BackendHealth("fs", fail_threshold=2)
    pol.attach_health(h)
    exc = OSError(5, "dying ssd")
    h.record_failure("write", exc)
    h.record_failure("write", exc)
    assert pol.replans == 1 and sum(pol.plan.offload) == 0
    assert pol.last_health_event.kind == "failing"
    h.record_success("write", 0.001)
    assert pol.replans == 2 and sum(pol.plan.offload) == n0


def test_adaptive_replan_scales_with_latency_degradation(pkg):
    pol = pkg.policies.AdaptivePolicy()
    pol.on_profile(_profiles(pkg), 2e9)
    n0 = sum(pol.plan.offload)
    assert n0 > 0
    pol.on_health_event(pkg.res.HealthEvent(
        kind="degraded", backend="fs", op="write",
        consecutive_failures=0, latency_ratio=100.0))
    assert pol.replans == 1 and sum(pol.plan.offload) < n0


def test_replan_before_profile_is_a_noop(pkg):
    pol = pkg.policies.AdaptivePolicy()
    pol.on_health_event(pkg.res.HealthEvent(
        kind="failing", backend="fs", op="write",
        consecutive_failures=3, latency_ratio=1.0))
    assert pol.replans == 0 and pol.plan is None


@pytest.mark.parametrize("kind,ratio", [("failing", 1.0), ("degraded", 7.0),
                                        ("recovered", 1.0)])
def test_replans_equal_across_packages(kind, ratio):
    """The same profile and tiers re-plan to the same plan in both
    packages, for every kind of health event."""
    plans = []
    for pkg in (_pkg("jax"), _pkg("torch")):
        pol = pkg.policies.AdaptivePolicy()
        tiers = [pkg.adaptive.TierBandwidth("host-ram", 6e9, 128 << 20),
                 pkg.adaptive.TierBandwidth("fs", 1.5e9, None)]
        pol.on_profile([pkg.adaptive.ModuleProfile(f"seg0_l{i}",
                                                   (40 + 8 * i) << 20,
                                                   0.02 + 0.01 * i)
                        for i in range(6)], tiers)
        pol.on_health_event(pkg.res.HealthEvent(
            kind=kind, backend="fs", op="write", consecutive_failures=0,
            latency_ratio=ratio))
        plans.append((pol.plan.offload, pol.plan.last_offloaded,
                      pol.replans))
    assert plans[0] == plans[1]


# ====================================== the port's engine, end to end

class DrainedSpoolPolicy(SpoolPolicy):
    """Every stage to the spool, and every layer's store landed before
    backward (the head stage waits for them), so backward reads each
    layer back through the backend instead of forwarding it."""
    spool = None

    def should_offload(self, stage, profile=None):
        if profile is not None and profile.name == "head":
            self.spool.wait_io()
        return True


def _session(policy, io, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("seq_len", 32)
    kw.setdefault("seed", 0)
    kw.setdefault("min_offload_elements", 0)
    s = TrainSession("small-gpt", device="cpu", policy=policy, io=io,
                     attn_impl="torch", **kw)
    if isinstance(policy, DrainedSpoolPolicy):
        policy.spool = s.spool
    return s


def _params(sess):
    from repro_torch.core.tree import tree_flatten
    return [t.detach().clone() for t in tree_flatten(sess.params)[0]]


@pytest.fixture(scope="module")
def keep5():
    with _session(KeepPolicy(), SpoolIoConfig(backend="mem")) as s:
        losses = s.run(5).losses
        return losses, _params(s)


def test_staged_fetch_failure_recomputes_bitwise(keep5):
    """Unrecoverable reads after step 1: every later fetch exhausts its
    retries and recomputes its stage; losses and parameters stay
    bitwise equal to keep."""
    io = SpoolIoConfig(backend="fault:fs", retry_attempts=2,
                       retry_backoff_s=1e-3)
    with _session(DrainedSpoolPolicy(), io) as sess:
        losses = list(sess.run(1).losses)
        sess.spool.backend.arm_read_failures(10_000)
        losses += sess.run(2).losses
        stats, params = sess.spool.stats.snapshot(), _params(sess)
        injected = dict(sess.spool.backend.injected)
    assert injected["read_failures"] > 0
    assert stats.fetch_fallbacks > 0 and stats.load_retries > 0
    assert losses == keep5[0][:3]
    assert sess.engine.on_fetch_fail == "recompute"


def test_staged_on_fetch_fail_raise_mode():
    io = SpoolIoConfig(backend="fault:fs", retry_attempts=1,
                       retry_backoff_s=1e-3, on_fetch_fail="raise")
    with _session(DrainedSpoolPolicy(), io) as sess:
        assert sess.engine.on_fetch_fail == "raise"
        sess.run(1)
        sess.spool.backend.arm_read_failures(10_000)
        with pytest.raises(SpoolLoadError):
            sess.run(1)
        sess.spool.backend.arm_read_failures(0)


def test_chaos_device_death_mid_run_end_to_end(keep5, tmp_path):
    """On a fault-wrapped 3-way stripe, device 1 dies after step 2 and
    reads raise 5 times: every step completes, retry, recompute fallback
    and rebalance each fire, losses and final parameters are bitwise
    equal to keep, and the metrics rows record the incident."""
    dirs = [str(tmp_path / f"d{i}") for i in range(3)]
    io = SpoolIoConfig(backend="fault:striped:" + ",".join(dirs),
                       retry_attempts=2, retry_backoff_s=1e-3)
    mp = str(tmp_path / "m.jsonl")
    losses = []
    with _session(DrainedSpoolPolicy(), io, metrics_path=mp) as sess:
        harness = tres.ChaosHarness(sess.spool.backend)
        assert harness.fault is not None and harness.striped is not None
        for step in range(5):
            if step == 2:
                sess.spool.wait_io()
                harness.kill_device(1)
                harness.raising_reads(5)
            losses += sess.run(1).losses
        report, stats = harness.report(), sess.spool.stats.snapshot()
        params = _params(sess)
    with open(mp) as f:
        rows = [json.loads(line) for line in f]
    assert stats.load_retries > 0 and stats.fetch_fallbacks > 0
    assert report["read_failures"] == 5
    assert report["rebalanced_chunks"] > 0 and report["devices_down"] == 1
    assert losses == keep5[0]
    assert all(torch.equal(a, b) for a, b in zip(params, keep5[1]))
    assert len(rows) == 5 and all("resilience_health" in r for r in rows)
    assert sum(r["resilience_fetch_fallbacks"] for r in rows) \
        == stats.fetch_fallbacks
    assert rows[-1]["resilience_devices_down"] == 1
    assert rows[0]["resilience_devices_down"] == 0
    assert all(not os.listdir(d) for d in dirs)


def test_metric_keys_match_a_jax_staged_session(tmp_path):
    """A managed backend over a faulty striped SSD tier: the port's rows
    and a JAX staged session's rows on the same config carry the same
    cache_* and resilience_* keys."""
    from repro.configs.base import SpoolIoConfig as JIo
    from repro.session import TrainSession as JSession
    keys = {}
    for name in ("jax", "torch"):
        spec = (f"managed:64kb,fault:striped:{tmp_path}/{name}0,"
                f"{tmp_path}/{name}1")
        mp = str(tmp_path / f"{name}.jsonl")
        if name == "jax":
            with JSession("small-gpt", engine="staged", policy="spool",
                          io=JIo(backend=spec), batch_size=2, seq_len=32,
                          seed=0, min_offload_elements=0,
                          metrics_path=mp, ckpt_dir=str(tmp_path / "ck"),
                          ) as s:
                s.run(1)
        else:
            with _session("spool", SpoolIoConfig(backend=spec),
                          metrics_path=mp) as s:
                s.run(1)
        with open(mp) as f:
            row = json.loads(f.readline())
        keys[name] = {k for k in row
                      if k.startswith(("cache_", "resilience_"))}
    assert keys["torch"] == keys["jax"]
    assert "cache_evictions" in keys["torch"]
    assert "resilience_devices_down" in keys["torch"]
