"""The port's tracing (`repro_torch.obs`) against the JAX package's
`repro.obs`, and the traced training and serving paths of the port.

  * `overlap.analyze` of both packages on one seeded synthetic event list
    (activation and optimizer-state spans, counters): equal dicts.
  * One tracer's events exported by both packages: each package's
    `validate_trace` accepts both files, and the two documents agree.
  * The ring-buffer cases of tests/test_obs.py (drop count, cursor, span
    on exception, injectable clock, disabled no-op), run against each
    package's tracer.
  * A traced port session: losses and parameters bitwise equal to the
    untraced run, a valid trace with one `engine.step` span a step and
    an `io.write` span per store, every fetch wait keyed to a read of
    the same blob, and metrics rows with the JAX staged session's
    `obs_*` key set.
    `benchmarks/torch_trace_split.py` splits each step of that trace
    into parts that add up.
  * `python -m repro_torch.launch.serve --trace` writes a valid trace
    with the `kv.*` and `serve.*` events.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import obs as jobs  # noqa: E402
from repro.configs.paper_models import small_gpt as jax_small_gpt  # noqa
from repro.obs import export as jexport  # noqa: E402
from repro.obs import overlap as joverlap  # noqa: E402
from repro.obs import tracer as jtracer  # noqa: E402
from repro.session import TrainSession as JaxSession  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs import SpoolIoConfig  # noqa: E402
from repro_torch.configs.paper_models import small_gpt  # noqa: E402
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs import overlap as toverlap  # noqa: E402
from repro_torch.obs import tracer as ttracer  # noqa: E402
from repro_torch.session import TrainSession  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmarks import torch_trace_split  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

MS = 1_000_000          # ns per millisecond
B, S = 2, 32
MIN_OFF = 2 ** 10
PACKAGES = {"jax": (jobs, jtracer), "torch": (tobs, ttracer)}


def _cfg():
    return dataclasses.replace(small_gpt(128, 2), dtype="float32")


def _synthetic_events(seed=0, n=400):
    """Spans of every name the analyzer reads, on a few keys (some of
    them optimizer-moment keys), with random overlaps, plus instants."""
    rng = np.random.default_rng(seed)
    names = (toverlap.IO_SPANS + (
        toverlap.FETCH_WAIT_SPAN, toverlap.STORE_SPAN, toverlap.LOAD_SPAN,
        toverlap.DECODE_SPAN, toverlap.ENCODE_SPAN)
        + toverlap.OPT_WORKER_SPANS + toverlap.OPT_EXPOSED_SPANS
        + (toverlap.OPT_UPDATE_SPAN, "engine.fwd", "spool.offload"))
    keys = [f"mb0_s{i}" for i in range(5)] + ["opt3_s0", "opt3_s1"]
    events = []
    for _ in range(n):
        name = names[rng.integers(len(names))]
        ts = int(rng.integers(0, 500 * MS))
        dur = -1 if rng.random() < 0.1 else int(rng.integers(0, 40 * MS))
        events.append((name, "t", ts, dur,
                       {"key": keys[rng.integers(len(keys))]}))
    events.sort(key=lambda ev: ev[2])
    counters = {"prefetch.issued": 9, "prefetch.hit": 6,
                "prefetch.late": 3, "prefetch.ghost": 1}
    return events, counters


@pytest.mark.parametrize("seed", [0, 1])
def test_analyze_matches_jax(seed):
    events, counters = _synthetic_events(seed)
    want = joverlap.analyze(events, counters)
    got = toverlap.analyze(events, counters)
    assert got == want
    assert want["opt_io_busy_s"] > 0 and want["stall_read_s"] > 0
    assert toverlap.predicted_vs_measured(
        {"io_hidden_frac": 0.5, "t_io_s": 1.0, "t_opt_io_s": 0.2}, got) == \
        joverlap.predicted_vs_measured(
            {"io_hidden_frac": 0.5, "t_io_s": 1.0, "t_opt_io_s": 0.2}, want)


def test_both_packages_export_and_validate_each_others_traces(tmp_path):
    t = [0]

    def clock():
        t[0] += MS
        return t[0]

    tr = ttracer.Tracer(clock=clock)
    with tr.span("io.write", cat="io", args={"key": "k", "kind": "fs"}):
        pass
    with tr.span("spool.fetch_wait", cat="spool", args={"key": "k",
                                                        "shard": 1}):
        pass
    tr.instant("spool.offload", cat="spool", args={"key": "k"})
    tr.add("prefetch.issued")
    paths = {}
    for name, export in (("torch", texport), ("jax", jexport)):
        paths[name] = export.write_chrome_trace(
            str(tmp_path / f"{name}.json"), tr, extra={"arch": "x"})
    docs = {k: json.load(open(p)) for k, p in paths.items()}
    assert docs["torch"]["traceEvents"] == docs["jax"]["traceEvents"]
    pids = {ev["pid"] for ev in docs["torch"]["traceEvents"]}
    assert pids == {0, 1, 2}
    for path in paths.values():
        assert texport.validate_trace(path, ("io", "spool")) == []
        assert jexport.validate_trace(path, ("io", "spool")) == []
    bad = {"traceEvents": [{"name": "x", "ph": "X", "pid": 0, "tid": 0,
                            "ts": -1}]}
    assert texport.validate_trace(bad) and jexport.validate_trace(bad)


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_tracer_cases_of_both_packages(package):
    """tests/test_obs.py's ring cases, against either package's tracer."""
    obs, tracer_mod = PACKAGES[package]
    Tracer = tracer_mod.Tracer
    # a full ring overwrites its oldest events and counts each overwrite
    tr = Tracer(ring_size=8)
    for i in range(20):
        tr.instant(f"ev{i}")
    (ring,) = tr.rings()
    assert (ring.total, ring.dropped, tr.dropped(), tr.total_events()) == \
        (20, 12, 12, 20)
    assert [ev[0] for ev in ring.snapshot()] == [f"ev{i}"
                                                 for i in range(12, 20)]
    # incremental cursors lose nothing and repeat nothing
    tr = Tracer(ring_size=64)
    for i in range(3):
        tr.instant(f"a{i}")
    first, cur = tr.snapshot_new()
    for i in range(2):
        tr.instant(f"b{i}")
    second, cur = tr.snapshot_new(cur)
    third, cur = tr.snapshot_new(cur)
    assert [ev[0] for ev in first] == ["a0", "a1", "a2"]
    assert [ev[0] for ev in second] == ["b0", "b1"] and third == []
    # a span that raises still records its complete event
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("boom", cat="t"):
            raise RuntimeError("x")
    (ev,) = tr.snapshot()
    assert tr.open_spans() == 0 and ev[0] == "boom" and ev[3] >= 0
    # the injected clock times spans and instants exactly
    t = [0]

    def clock():
        t[0] += 5 * MS
        return t[0]

    tr = Tracer(clock=clock)
    with tr.span("a", cat="t"):
        pass
    tr.instant("i", cat="t")
    a, i = tr.snapshot()
    assert a[0] == "a" and a[3] == 5 * MS
    assert i[0] == "i" and i[3] == -1 and i[2] > a[2]
    # disabled: the module helpers are no-ops on one shared null span
    prev = tracer_mod._TRACER
    tracer_mod._TRACER = None
    try:
        with obs.span("x", cat="t", key=1) as sp:
            sp.set(bytes=3)
        assert obs.span("y") is sp
        obs.instant("y")
        obs.count("c")
        obs.gauge("g", 1.0)
        assert not obs.is_enabled() and obs.get_tracer() is None
    finally:
        tracer_mod._TRACER = prev


def _session_run(tmp_path, name, *, trace, steps=2):
    metrics = tmp_path / f"{name}.jsonl"
    with TrainSession(
            _cfg(), device="cpu", policy="spool", optimizer="sgd", lr=1e-2,
            batch_size=B, seq_len=S, min_offload_elements=MIN_OFF,
            io=SpoolIoConfig(backend="fs", directory=str(tmp_path / name)),
            metrics_path=str(metrics),
            trace=str(tmp_path / f"{name}.trace.json") if trace else None
            ) as sess:
        result = sess.run(steps)
        params = [t.clone() for t in tree_flatten(sess.params)[0]]
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    # closed: every store has landed
    return result, params, rows, sess.spool.stats.num_stores


def test_traced_session_is_bitwise_and_its_trace_is_whole(tmp_path):
    plain, p_plain, rows_plain, _ = _session_run(tmp_path, "plain",
                                                 trace=False)
    traced, p_traced, rows, stores = _session_run(tmp_path, "traced",
                                                  trace=True)
    assert not tobs.is_enabled()        # the session's tracer is gone
    assert traced.losses == plain.losses
    assert all(torch.equal(a, b) for a, b in zip(p_plain, p_traced))
    assert not any(k.startswith("obs_") for k in rows_plain[0])
    path = str(tmp_path / "traced.trace.json")
    assert texport.validate_trace(
        path, ("engine", "spool", "io", "codec")) == []
    doc = json.load(open(path))
    assert doc["otherData"]["open_spans"] == 0
    assert doc["otherData"]["arch"] == _cfg().name
    host = [ev for ev in doc["traceEvents"] if ev["pid"] == 0]
    names = [ev["name"] for ev in host]
    assert names.count("engine.step") == 2
    assert names.count("engine.fwd") == names.count("engine.bwd") == 2
    assert names.count("io.write") == stores > 0
    read_keys = {ev["args"]["key"] for ev in host if ev["name"] == "io.read"}
    waits = [ev for ev in host if ev["name"] == "spool.fetch_wait"]
    assert waits and all(ev["args"]["key"] in read_keys for ev in waits)
    for r in rows:
        assert 0.0 <= r["obs_io_hidden_frac"] <= 1.0
        assert r["obs_store_s"] > 0 and r["obs_prefetch_issued"] > 0
        assert r["obs_exposed_wait_s"] <= r["obs_stall_read_s"] + \
            r["obs_stall_decode_s"] + r["obs_stall_queue_s"] + 1e-9
    split = torch_trace_split.split(path)
    assert [r["step"] for r in split] == [0, 1]
    for r in split:
        assert r["main_rest_s"] == pytest.approx(r["step_s"]
                                                 - r["exposed_wait_s"])
        assert 0 <= r["load_pinned_copy_s"] <= r["load_busy_s"]
        assert r["load_read_s"] + r["load_decode_s"] \
            + r["load_pinned_copy_s"] >= r["load_busy_s"] - 1e-9
        assert r["forward_s"] + r["backward_s"] + r["update_s"] \
            <= r["step_s"] + 1e-9


def test_traced_rows_have_the_jax_obs_keys(tmp_path):
    _, _, rows, _ = _session_run(tmp_path, "t", trace=True, steps=1)
    jcfg = dataclasses.replace(jax_small_gpt(128, 2), dtype="float32")
    jmetrics = tmp_path / "jax.jsonl"
    with JaxSession(jcfg, engine="staged", policy="spool", optimizer="sgd",
                    lr=1e-2, batch_size=B, seq_len=S,
                    min_offload_elements=MIN_OFF, metrics_path=str(jmetrics),
                    trace=str(tmp_path / "jax.trace.json")) as sess:
        sess.run(1)
    jrow = json.loads(jmetrics.read_text().splitlines()[0])
    obs_keys = {k for k in rows[0] if k.startswith("obs_")}
    assert obs_keys and obs_keys == {k for k in jrow
                                     if k.startswith("obs_")}


def test_serve_cli_writes_a_valid_trace(tmp_path, capsys):
    path = str(tmp_path / "serve.json")
    serve_cli.main(["--arch", "small-gpt", "--device", "cpu", "--attn-impl",
                    "torch", "--quantum", "3", "--requests", "6", "--batch",
                    "2", "--prompt-len", "16", "--max-new", "6",
                    "--cache-len", "32", "--page-tokens", "8",
                    "--kv-dir", str(tmp_path / "kv"), "--trace", path])
    assert f"trace -> {path}" in capsys.readouterr().out
    assert not tobs.is_enabled()
    assert texport.validate_trace(path, ("kv", "serve", "spool", "io")) \
        == []
    names = {ev["name"] for ev in json.load(open(path))["traceEvents"]}
    assert {"kv.prefill", "kv.evict", "kv.restore", "serve.decode",
            "serve.run", "serve.preempt", "io.read"} <= names
