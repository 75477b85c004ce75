"""The serving slice as a whole: the port's continuous-batching server
over the paged (spool-backed) and dense KV caches, against the JAX
package's server on the same weights and the same numpy-seeded request
trace, and against itself (paged vs dense bitwise, through eviction
round trips on the fs and mem spools), plus the accounting invariants
and the CLI. float32 small-gpt on the CPU."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs.paper_models import small_gpt
from repro_torch.kvcache import (KVCacheConfig, PageAllocator,
                                 PagePoolExhausted, Server, build_manager)
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import RunSettings

TOL = 1e-4
N_REQ, MAX_NEW = 6, 9


def _kvcfg(quantum=0):
    return KVCacheConfig(page_tokens=8, max_seq_len=48, quantum=quantum,
                         prefetch_depth=2, dtype="float32")


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's server on float32 small-gpt: (params as numpy,
    {run name: finished sequences by rid, schedule log})."""
    jax = pytest.importorskip("jax")
    from repro.configs.paper_models import small_gpt as jsmall
    from repro.kvcache import KVCacheConfig as JKV
    from repro.launch import serve as jserve
    from repro.models.api import build_model as jbuild
    from repro.models.transformer import RunSettings as JRS
    cfg = dataclasses.replace(jsmall(), dtype="float32")
    api = jbuild(cfg)
    params = api.init(jax.random.key(0))
    settings = JRS(attn_impl="xla", attn_chunk=256, param_dtype="float32")
    runs = {}
    for name, kind, quantum in (("dense", "dense", 0),
                                ("paged_q3", "paged", 3)):
        spool, owned = (jserve.build_kv_spool("mem") if kind == "paged"
                        else (None, []))
        try:
            srv = jserve.make_server(
                api, params, settings,
                JKV(page_tokens=8, max_seq_len=48, quantum=quantum,
                    prefetch_depth=2, dtype="float32"),
                kind=kind, n_slots=2, spool=spool, record_logits=True)
            jserve.synth_requests(srv, N_REQ, 12, MAX_NEW, cfg.vocab_size, 7)
            srv.run()
        finally:
            if spool is not None:
                spool.close()
        runs[name] = ({s.rid: s for s in srv.finished}, srv.schedule_log)
    return jax.tree.map(np.asarray, params), runs


@pytest.fixture(scope="module")
def runtime(jax_side):
    np_params, _ = jax_side
    api = build_model(dataclasses.replace(small_gpt(), dtype="float32"))
    params = params_from_jax(np_params, device="cpu")
    return api, params, RunSettings(attn_impl="torch", attn_chunk=256,
                                    param_dtype="float32", device="cpu")


def _serve(runtime, kind, *, quantum=0, backend="mem", kv_dir=None,
           n_slots=2):
    api, params, settings = runtime
    spool = (serve.build_kv_spool(backend, kv_dir, "byteplane")
             if kind == "paged" else None)
    try:
        server = serve.make_server(api, params, settings, _kvcfg(quantum),
                                   kind=kind, n_slots=n_slots, spool=spool,
                                   record_logits=True)
        serve.synth_requests(server, N_REQ, 12, MAX_NEW,
                             api.cfg.vocab_size, 7)
        report = server.run()
    finally:
        if spool is not None:
            spool.close()
    return server, report


def _by_rid(server):
    return {s.rid: s for s in server.finished}


def _assert_bitwise(a, b):
    assert set(a) == set(b) and len(a) == N_REQ
    for rid in a:
        assert a[rid].tokens == b[rid].tokens
        assert len(a[rid].logits) == MAX_NEW
        for x, y in zip(a[rid].logits, b[rid].logits):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------- port vs JAX

@pytest.mark.parametrize("kind,quantum,jax_run", [
    ("dense", 0, "dense"), ("paged", 0, "dense"), ("paged", 3, "paged_q3")])
def test_port_matches_jax(runtime, jax_side, kind, quantum, jax_run):
    server, _ = _serve(runtime, kind, quantum=quantum)
    want, want_log = jax_side[1][jax_run]
    got = _by_rid(server)
    assert set(got) == set(want)
    for rid in want:
        assert got[rid].tokens == [int(t) for t in want[rid].tokens]
        np.testing.assert_allclose(np.stack(got[rid].logits),
                                   np.stack(want[rid].logits),
                                   rtol=TOL, atol=TOL)
    if jax_run == "paged_q3":
        assert server.schedule_log == want_log


# ------------------------------------------------------- inside the port

def test_paged_dense_bitwise(runtime):
    sp, rp = _serve(runtime, "paged")
    sd, rd = _serve(runtime, "dense")
    assert rp.preemptions == 0 and rp.generated_tokens == rd.generated_tokens
    _assert_bitwise(_by_rid(sp), _by_rid(sd))


@pytest.mark.parametrize("backend", ["fs", "mem"])
def test_eviction_roundtrip_bitwise(runtime, backend, tmp_path):
    kv_dir = str(tmp_path) if backend == "fs" else None
    sp, rp = _serve(runtime, "paged", quantum=3, backend=backend,
                    kv_dir=kv_dir)
    sd, rd = _serve(runtime, "dense")
    assert rp.preemptions > 0
    assert rp.kv["pages_evicted"] == rp.kv["pages_restored"] > 0
    assert rp.peak_live > rp.n_slots >= rd.peak_live
    _assert_bitwise(_by_rid(sp), _by_rid(sd))
    if kv_dir:
        assert os.listdir(kv_dir) == []       # every blob dropped


def test_schedule_deterministic(runtime):
    s1, _ = _serve(runtime, "paged", quantum=3)
    s2, _ = _serve(runtime, "paged", quantum=3, backend="fs")
    assert s1.schedule_log == s2.schedule_log
    assert [q.tokens for q in s1.finished] == [q.tokens for q in s2.finished]


def test_allocator_deterministic_and_null_page():
    al = PageAllocator(8)            # pages 1..7 usable, 0 reserved
    a = al.alloc(3)
    assert a == [1, 2, 3]
    al.free([2])
    assert al.alloc(1) == [2]        # LIFO recycle
    b = al.alloc(4)
    assert b == [4, 5, 6, 7]
    assert al.available == 0 and al.in_use == 7
    with pytest.raises(PagePoolExhausted):
        al.alloc(1)
    al.free(a + b)
    assert al.available == 7 and al.high_water == 7
    cfg = KVCacheConfig(page_tokens=16, max_seq_len=100)
    assert (cfg.max_pages, cfg.padded_seq_len) == (7, 112)
    assert cfg.resolve_pool_pages(4) == 29


def test_accounting_invariants(runtime):
    server, r = _serve(runtime, "paged", quantum=3)
    assert r.requests == N_REQ
    assert r.generated_tokens == sum(
        len(s.tokens) for s in server.finished) == N_REQ * MAX_NEW
    # exactly one token per request came from prefill logits
    assert r.decode_slot_tokens == r.generated_tokens - r.requests
    assert r.decode_slot_tokens <= r.decode_steps * r.n_slots
    assert r.prompt_tokens == sum(len(s.prompt) for s in server.finished)
    assert r.kv["prefills"] == N_REQ
    assert r.kv["bytes_evicted"] == r.kv["bytes_restored"] > 0


def test_dense_cannot_evict_and_submit_validation(runtime):
    api, params, settings = runtime
    cache = build_manager("dense", api, params, settings,
                          KVCacheConfig(page_tokens=8, max_seq_len=16), 2)
    with pytest.raises(RuntimeError, match="cannot evict"):
        cache.evict(object())
    srv = Server(cache)
    with pytest.raises(ValueError):
        srv.submit([], 4)
    with pytest.raises(ValueError, match="exceeds"):
        srv.submit(np.arange(10), 10)
    with pytest.raises(ValueError, match="needs a spool"):
        build_manager("paged", api, params, settings, _kvcfg(), 2)


def test_windowed_layers_ride_evictions(jax_side):
    """Sliding-window layers keep slot-resident ring caches that evict
    as one per-sequence state blob (exact-length prefill). Held against
    the JAX package's server and, bitwise, against the port's dense
    cache. Regression: the parked state must be a host copy, not a view
    of the slot rows that the slot's next occupant overwrites."""
    jax = pytest.importorskip("jax")
    from repro.configs.paper_models import small_gpt as jsmall
    from repro.kvcache import KVCacheConfig as JKV
    from repro.launch import serve as jserve
    from repro.models.api import build_model as jbuild
    from repro.models.transformer import RunSettings as JRS
    kw = dict(dtype="float32", sliding_window=8, local_global_period=2)
    japi = jbuild(dataclasses.replace(jsmall(), **kw))
    jparams = japi.init(jax.random.key(1))
    spool, _ = jserve.build_kv_spool("mem")
    try:
        jsrv = jserve.make_server(
            japi, jparams, JRS(attn_impl="xla", attn_chunk=256,
                               param_dtype="float32"),
            JKV(page_tokens=8, max_seq_len=48, quantum=3, prefetch_depth=2,
                dtype="float32"),
            kind="paged", n_slots=2, spool=spool, record_logits=True)
        jserve.synth_requests(jsrv, N_REQ, 12, MAX_NEW, 2048, 7)
        jsrv.run()
    finally:
        spool.close()
    api = build_model(dataclasses.replace(small_gpt(), **kw))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rt = (api, params, RunSettings(attn_impl="torch", attn_chunk=256,
                                   param_dtype="float32", device="cpu"))
    sp, rp = _serve(rt, "paged", quantum=3)
    sd, _ = _serve(rt, "dense")
    assert sp.cache.resident[0] and sp.cache.exact_prefill
    assert rp.preemptions > 0 and rp.kv["pages_evicted"] > 0
    _assert_bitwise(_by_rid(sp), _by_rid(sd))
    got, want = _by_rid(sp), {s.rid: s for s in jsrv.finished}
    assert sp.schedule_log == jsrv.schedule_log
    for rid in want:
        assert got[rid].tokens == [int(t) for t in want[rid].tokens]
        np.testing.assert_allclose(np.stack(got[rid].logits),
                                   np.stack(want[rid].logits),
                                   rtol=TOL, atol=TOL)


def test_cli_end_to_end(capsys, tmp_path):
    kv_dir = str(tmp_path / "kv")
    serve.main(["--arch", "small-gpt", "--device", "cpu", "--attn-impl",
                "torch", "--requests", "5", "--batch", "2", "--prompt-len",
                "20", "--max-new", "6", "--cache-len", "32",
                "--page-tokens", "8", "--quantum", "2", "--kv-backend", "fs",
                "--kv-dir", kv_dir, "--json", str(tmp_path / "r.json")])
    out = capsys.readouterr().out
    assert "served 5 requests on 2 slots (paged cache)" in out
    assert "generated: 30 tokens" in out
    assert "kernels: flash_attention launches 0" in out    # CPU: no kernel
    assert "evicted" in out and os.listdir(kv_dir) == []
    assert (tmp_path / "r.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.build_runtime("small-gpt", device="cuda")
