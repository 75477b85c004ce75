"""The port's optimizer overlap (`repro_torch.optim.overlap.OptBridge`, the
jit engine's `opt_overlap` and `host_offload="opt_state"`) against the
port's own fused update and against the JAX package's optimizers.

  * Bitwise inside the port: the serial update with the optimizer state
    staged through the spool between steps, the eager overlap and its
    "sync" drain give the plain fused update's losses, parameters and
    moments, for adamw (clip-free), sgd-momentum and sgd, over `fs` and
    `mem`. The JAX package's eager bridge is held to its serial update
    only within a tolerance (its sgd-momentum case fails bitwise), the
    port's to its own bit for bit.
  * The JAX package's cases (tests/test_opt_overlap.py) on the port: an
    armed read failure on the moment leases rides the spool's retries
    and changes nothing; a fully label-masked batch skips every
    unchanged write-back; the trace holds `engine.opt_update`,
    `engine.opt_join`, `opt.fetch` and `opt.stage`, and the rows carry a
    non-zero `opt_io_busy_s`.
  * The eager run with the interpreter switching threads every
    microsecond; the bridge's join timeout, the sync drain's missing
    taps, and the refusals: the staged engine with the overlap, a clipping optimizer,
    an optimizer without a per-leaf kernel.
  * `leaf_update` against the JAX package's on numpy inputs from a seed,
    rtol 1e-6 / atol 1e-6 (the bar of
    tests/test_torch_train.py::test_optimizer_updates_match_jax), and
    equal to the slices of the fused update bit for bit.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs import SpoolIoConfig  # noqa: E402
from repro_torch.configs.paper_models import small_gpt  # noqa: E402
from repro_torch.core.spool import build_spool  # noqa: E402
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.io.faults import FaultInjectingBackend  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim.overlap import OptBridge  # noqa: E402
from repro_torch.resilience import unwrap_chain  # noqa: E402
from repro_torch.session import TrainSession  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

CFG = dataclasses.replace(small_gpt(128, 2), dtype="float32")
STEPS = 3
N_STAGES = 2            # small_gpt(_, 2): two decoder layers
OPTS = {"adamw": lambda: topt.adamw(1e-3, clip_norm=None),
        "sgd-momentum": lambda: topt.sgd(1e-3, momentum=0.9),
        "sgd": lambda: topt.sgd(1e-3)}


def _flat(tree):
    return None if tree is None else [t.detach().cpu().clone()
                                      for t in tree_flatten(tree)[0]]


def _run(mode, *, optimizer="adamw", backend="mem", trace=None,
         loader=None, arm_reads=0, steps=STEPS):
    """One jit-engine session on the CPU; mode is "plain" (the fused
    update, no spool), "serial" (the fused update with the optimizer
    state staged between steps), "sync" or True (the eager worker)."""
    io = SpoolIoConfig(
        backend=backend,
        host_offload="opt_state" if mode == "serial" else "none")
    sess = TrainSession(
        CFG, engine="jit", io=io, optimizer=OPTS[optimizer](),
        opt_overlap=mode if mode in (True, "sync") else None,
        batch_size=2, seq_len=32, seed=3, device="cpu",
        min_offload_elements=2 ** 8, trace=trace, loader=loader)
    try:
        if arm_reads:
            for b in unwrap_chain(sess.spool.backend):
                if isinstance(b, FaultInjectingBackend):
                    b.arm_read_failures(arm_reads, key_substr="opt")
        res = sess.run(steps)
        bridge = sess.opt_bridge
        opt = (bridge.materialize() if bridge is not None and bridge.seeded
               else sess.opt_state)
        spool = sess.engine.spool
        return {
            "losses": res.losses,
            "params": _flat(sess.params),
            "mu": _flat(opt.mu), "nu": _flat(opt.nu),
            "opt_step": int(opt.step),
            "bridge": bridge.stats() if bridge is not None else None,
            "load_retries": spool.stats.load_retries,
            "opt_skipped_bytes": spool.stats.opt_skipped_bytes,
            "stats": [r.stats for r in res.reports],
            "obs": [r.obs for r in res.reports],
            "rows": [r.to_metrics() for r in res.reports],
        }
    finally:
        sess.close()


def _assert_bitwise(a, b):
    assert a["losses"] == b["losses"], (a["losses"], b["losses"])
    for key in ("params", "mu", "nu"):
        if a[key] is None:
            assert b[key] is None, key
            continue
        assert len(a[key]) == len(b[key]), key
        for x, y in zip(a[key], b[key]):
            assert torch.equal(x, y), key
    assert a["opt_step"] == b["opt_step"] == STEPS


@pytest.fixture(scope="module")
def plain_runs():
    return {name: _run("plain", optimizer=name) for name in OPTS}


@pytest.fixture(scope="module")
def eager_run(tmp_path_factory):
    trace = str(tmp_path_factory.mktemp("optov") / "trace.json")
    out = _run(True, trace=trace)
    out["trace"] = trace
    return out


# ------------------------------------------------------------- parity

@pytest.mark.parametrize("mode", ["serial", "eager", "sync"])
@pytest.mark.parametrize("backend", ["fs", "mem"])
@pytest.mark.parametrize("optimizer", sorted(OPTS))
def test_modes_match_the_fused_update_bitwise(plain_runs, optimizer,
                                              backend, mode):
    """The tentpole bar inside the port: per-step losses, final params
    and the full final optimizer state bit for bit the plain fused
    update's, whatever carries the state between steps."""
    got = _run({"eager": True}.get(mode, mode), optimizer=optimizer,
               backend=backend)
    _assert_bitwise(plain_runs[optimizer], got)
    if mode == "serial":
        # the moments went out after each step and came back before the
        # next (forwarded from a store in flight, or reloaded); plain sgd
        # stages only its step counter, kept in memory
        assert all((st.bytes_loaded + st.bytes_forwarded > 0)
                   == (optimizer != "sgd") for st in got["stats"][1:])
        return
    bridge = got["bridge"]
    assert bridge["opt_updates"] == STEPS * N_STAGES
    if optimizer == "sgd":
        # no moment: no lease at all, the bridge only reorders updates
        assert bridge["opt_fetched_bytes"] == bridge["opt_staged_bytes"] \
            == 0
    else:
        assert bridge["opt_fetched_bytes"] > 0
        assert bridge["opt_staged_bytes"] == bridge["opt_fetched_bytes"]


def test_rows_carry_the_bridge_counters_per_step(eager_run):
    rows = eager_run["rows"]
    assert [r["opt_updates"] for r in rows] == [N_STAGES] * STEPS
    assert all(r["engine"] == "jit" and r["opt_fetched_bytes"] > 0
               for r in rows)


def test_eager_overlap_under_a_short_switch_interval(plain_runs):
    """The worker and the training thread share the bridge's queue,
    pending set and counters, beside the spool's store and load threads:
    with the interpreter switching threads every microsecond the run is
    still the plain one bit for bit, every update counted once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _run(True, backend="fs")
    finally:
        sys.setswitchinterval(old)
    _assert_bitwise(plain_runs["adamw"], got)
    assert got["bridge"]["opt_updates"] == STEPS * N_STAGES
    assert got["bridge"]["opt_staged_bytes"] == \
        got["bridge"]["opt_fetched_bytes"] > 0


# ------------------------------------------------- resilience ladder

def test_opt_fetch_failure_rides_retry_ladder(plain_runs):
    """A moment read that fails mid-backward is retried by the spool's
    load workers; the run completes and matches the plain one bit for
    bit."""
    faulted = _run(True, backend="fault:mem", arm_reads=2)
    _assert_bitwise(plain_runs["adamw"], faulted)
    assert faulted["load_retries"] >= 1, faulted["load_retries"]


# ------------------------------------------------- write-back policy

class _MaskedLoader:
    """Every label masked (-1): the loss is 0 over 0 tokens, grads are
    exactly zero, and adamw moments stay at their seeded zeros."""

    def __init__(self, batch, seq):
        self._batch = {
            "tokens": np.ones((batch, seq), np.int32),
            "labels": np.full((batch, seq), -1, np.int32)}

    def __iter__(self):
        return self

    def __next__(self):
        return dict(self._batch)

    def state_dict(self):
        return {}

    def load_state_dict(self, state):
        pass


def test_unchanged_moments_skip_writeback():
    out = _run(True, loader=_MaskedLoader(2, 32))
    assert out["losses"] == [0.0] * STEPS
    assert out["bridge"]["opt_stage_skips"] == STEPS * N_STAGES
    assert out["bridge"]["opt_skipped_bytes"] > 0
    assert out["opt_skipped_bytes"] == out["bridge"]["opt_skipped_bytes"]
    # nothing was re-staged after seeding: every lease was kept
    assert out["bridge"]["opt_staged_bytes"] == 0
    assert all(torch.count_nonzero(m) == 0 for m in out["mu"])


# ------------------------------------------------------ obs lane

def test_obs_attributes_opt_lane(eager_run):
    """Per-step rows carry the opt lane, and the trace has the worker
    and update spans the analyzer classifies on."""
    rows = [r for r in eager_run["obs"] if r]
    assert rows and any(r["opt_io_busy_s"] > 0 for r in rows)
    assert all(0.0 <= r["opt_hidden_frac"] <= 1.0 for r in rows)
    assert all(r["opt_update_s"] > 0 for r in rows)
    names = {e["name"] for e in
             json.load(open(eager_run["trace"]))["traceEvents"]
             if e.get("ph") == "X"}
    for want in ("engine.opt_update", "engine.opt_join", "opt.fetch",
                 "opt.stage"):
        assert want in names, (want, sorted(names))


def test_serial_staging_is_the_exposed_opt_lane(tmp_path):
    """The serial path's fetch and stage are the training thread's own
    spans: the analyzer counts them as exposed."""
    out = _run("serial", backend="fs", trace=str(tmp_path / "t.json"))
    names = {e["name"] for e in json.load(open(tmp_path / "t.json"))[
        "traceEvents"] if e.get("ph") == "X"}
    assert {"engine.opt_fetch", "engine.opt_stage"} <= names
    assert all(r["opt_exposed_wait_s"] > 0 for r in out["obs"][1:])


# ------------------------------------------------- the bridge alone

def _bridge_setup(eager, join_timeout=0.2):
    params = {"segments": [{"w": torch.randn(2, 8, 4)}],
              "embed": torch.randn(4, 8)}
    opt = topt.adamw(1e-2, clip_norm=None)
    spool = build_spool(SpoolIoConfig(backend="mem"),
                        min_offload_elements=0)
    bridge = OptBridge(opt, spool, eager=eager, join_timeout=join_timeout)
    bridge.seed(opt.init(params), params)
    return params, bridge, spool


def test_join_times_out_on_a_missing_tap():
    params, bridge, spool = _bridge_setup(eager=True)
    try:
        assert bridge.moment_bytes() == 2 * 2 * 8 * 4 * 4
        bridge.begin_step(params, 0)
        g = torch.ones(2, 8, 4)
        bridge.on_grads(0, 1, [g[1]])          # stage 0 never taps
        with pytest.raises(RuntimeError, match=r"timed out.*\[0\]"):
            bridge.finish_step(params, {"segments": [{"w": g}],
                                        "embed": torch.ones(4, 8)})
    finally:
        bridge.close()
        spool.close()


def test_sync_drain_reports_missing_taps_and_a_wrong_step():
    params, bridge, spool = _bridge_setup(eager=False)
    try:
        with pytest.raises(RuntimeError, match="at step 0, got 1"):
            bridge.begin_step(params, 1)
        bridge.begin_step(params, 0)
        with pytest.raises(RuntimeError, match="grad taps missing"):
            bridge.finish_step(params, {})
    finally:
        bridge.close()
        spool.close()
    assert spool.live_keys() == []


def test_refusals():
    spool = build_spool(SpoolIoConfig(backend="mem"))
    try:
        with pytest.raises(ValueError, match="clipping"):
            OptBridge(topt.adamw(1e-3), spool)          # clip 1.0
        no_kernel = dataclasses.replace(topt.sgd(1e-3), leaf_update=None)
        with pytest.raises(ValueError, match="per-leaf"):
            OptBridge(no_kernel, spool)
    finally:
        spool.close()
    with pytest.raises(ValueError, match="jit-engine"):
        TrainSession(CFG, engine="staged", opt_overlap=True, device="cpu")
    with pytest.raises(ValueError, match="jit-engine"):
        TrainSession(CFG, engine="staged", device="cpu",
                     io=SpoolIoConfig(backend="mem", opt_overlap=True))
    with pytest.raises(ValueError, match="clipping"):
        TrainSession(CFG, engine="jit", opt_overlap=True, device="cpu",
                     optimizer=topt.adamw(1e-3, clip_norm=1.0))
    # the meshes' dedup switch is ported: a bool, nothing else
    SpoolIoConfig(dedupe_replicas=False).validate()
    with pytest.raises(ValueError, match="dedupe_replicas"):
        SpoolIoConfig(dedupe_replicas="no").validate()


# ------------------------------------------------- the per-leaf kernel

@pytest.mark.parametrize("name,make_t,make_j", [
    ("adamw", lambda: topt.adamw(1e-2, clip_norm=None, warmup_steps=3),
     lambda: jopt.adamw(1e-2, clip_norm=None, warmup_steps=3)),
    ("sgd-momentum", lambda: topt.sgd(1e-2, momentum=0.9),
     lambda: jopt.sgd(1e-2, momentum=0.9)),
    ("sgd", lambda: topt.sgd(1e-2), lambda: jopt.sgd(1e-2)),
])
def test_leaf_update_matches_jax(name, make_t, make_j):
    rng = np.random.default_rng(7)
    p, g = (rng.standard_normal((16, 24)).astype(np.float32)
            for _ in range(2))
    m = rng.standard_normal((16, 24)).astype(np.float32) * 0.1
    v = np.abs(rng.standard_normal((16, 24))).astype(np.float32) * 0.01
    has_m, has_v = name != "sgd", name == "adamw"
    for step in (1, 2, 5):
        got = make_t().leaf_update(
            torch.from_numpy(p), torch.from_numpy(m) if has_m else None,
            torch.from_numpy(v) if has_v else None, torch.from_numpy(g),
            step)
        want = make_j().leaf_update(
            jnp.asarray(p), jnp.asarray(m) if has_m else None,
            jnp.asarray(v) if has_v else None, jnp.asarray(g),
            jnp.asarray(step, jnp.int32))
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("optimizer", sorted(OPTS))
def test_leaf_update_is_the_fused_update_per_slice(optimizer):
    """One layer's update through leaf_update is bitwise that layer's
    slice of the fused in-place update, at a slice size that splits the
    stacked leaf (CHUNK patched small)."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 10, 6, generator=g)}
    grads = {"w": torch.randn(3, 10, 6, generator=g)}
    opt = OPTS[optimizer]()
    state = opt.init(params)
    fused_p = {"w": params["w"].clone()}
    old = topt.CHUNK
    topt.CHUNK = 20
    try:
        _, fused = opt.update(grads, opt.init(fused_p), fused_p)
    finally:
        topt.CHUNK = old
    for li in range(3):
        m = state.mu["w"][li] if state.mu is not None else None
        v = state.nu["w"][li] if state.nu is not None else None
        new_p, new_m, new_v = opt.leaf_update(params["w"][li], m, v,
                                              grads["w"][li], 1)
        assert torch.equal(new_p, fused_p["w"][li])
        if new_m is not None:
            assert torch.equal(new_m, fused.mu["w"][li])
        if new_v is not None:
            assert torch.equal(new_v, fused.nu["w"][li])
