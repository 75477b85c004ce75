"""Serving the rest: decode and the paged server for the models that are
not pure transformers, through the port against the JAX package and
against itself. float32 on the CPU, small configs, one set of weights
(the port's init from a seed, handed to JAX as numpy arrays and to the
port through `models/convert.py`).

  * The streaming depthwise conv (`apply_conv1d(p, x, state)`).
  * `decode_step` after `prefill` for mamba2 (`reduced(mamba2-2.7b, 2)`),
    recurrentgemma (`reduced(recurrentgemma-9b, 5)`: both segments, a
    ring of 16 slots behind S=20) and T5 (`small_t5(128, 2)`, cross K/V at the
    encoder's length), per-row and shared positions, against JAX's
    `prefill` + `decode_step` at 2e-4, the in-place caches too.
  * The server: paged (mem and fs spools, quantum 0 and 3) vs dense
    bitwise for both models, every parked state restored bit for bit,
    tokens and logits against JAX's `Server` on the same trace (mamba2:
    JAX's dense server, whose paged manager refuses a model with no
    pageable block), JAX's schedule log for recurrentgemma's paged run;
    an encoder-decoder is refused by `build_manager`.
  * The scheduler's `eos_id`, `sample` and `time_fn` against JAX's on a
    stub cache with a fake clock.
  * `benchmarks/torch_serve_kv.py --quick --check` on the CPU.
"""
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks import torch_serve_kv  # noqa: E402
from repro.configs.base import reduced  # noqa: E402
from repro.configs.mamba2_2_7b import CONFIG as JAX_MAMBA2  # noqa: E402
from repro.configs.recurrentgemma_9b import CONFIG as JAX_RG  # noqa: E402
from repro.kvcache import KVCacheConfig as JKV  # noqa: E402
from repro.kvcache import Server as JServer  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.models.transformer import RunSettings as JRS  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs.paper_models import small_t5  # noqa: E402
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.kvcache import (KVCacheConfig, Server,  # noqa: E402
                                 build_manager)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import RunSettings  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = 2e-4
N_REQ, PROMPT, MAX_NEW = 4, 6, 7
# mamba2 keeps the full config's attention fields (no heads, no head
# dim): a paged cache with no pageable block must not resolve a head dim
JAX_CFGS = {"mamba2": lambda: dataclasses.replace(
                reduced(JAX_MAMBA2, layers=2), num_heads=0, num_kv_heads=0,
                head_dim=0),
            "recurrentgemma": lambda: reduced(JAX_RG, layers=5)}
# the JAX run each model's served tokens are held against
JAX_RUN = {"mamba2": ("dense", 0), "recurrentgemma": ("paged", 3)}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _runtime(tcfg):
    """(torch api, params, settings, numpy params) from the port's init."""
    api = build_model(tcfg)
    np_params = _numpy(api.init(torch.Generator().manual_seed(0)))
    params = params_from_jax(np_params, device="cpu")
    settings = RunSettings(attn_impl="torch", attn_chunk=8,
                           param_dtype="float32", device="cpu")
    return api, params, settings, np_params


@pytest.fixture(scope="module")
def models():
    """name -> (JAX cfg, torch runtime), built once per module."""
    built = {}

    def get(name):
        if name not in built:
            jcfg = dataclasses.replace(JAX_CFGS[name](), dtype="float32")
            built[name] = (jcfg, _runtime(
                ModelConfig(**dataclasses.asdict(jcfg))))
        return built[name]
    return get


def _jax_settings():
    return JRS(attn_impl="xla", attn_chunk=8, param_dtype="float32")


# ------------------------------------------------------- streaming conv

def test_streaming_conv_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    x = rng.normal(size=(2, 5, 6)).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32)
    jy, jst = jlayers.apply_conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                   jnp.asarray(x), jnp.asarray(st))
    ty, tst = layers.apply_conv1d(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        torch.from_numpy(x), torch.from_numpy(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


# ------------------------------------------------------- decode_step

def _decode_case(name, models):
    if name != "t5":
        return models(name)
    tcfg = dataclasses.replace(small_t5(128, 2), dtype="float32")
    from repro.configs.base import ModelConfig as JModelConfig
    return JModelConfig(**dataclasses.asdict(tcfg)), _runtime(tcfg)


@pytest.mark.parametrize("name", ["mamba2", "recurrentgemma", "t5"])
def test_decode_steps_match_jax(models, name):
    """Prefill S tokens into caches of 24, then 4 decode steps,
    alternating per-row (B,) positions and one shared position; logits
    and every cache leaf (written in place by the port) at 2e-4."""
    jcfg, (api, params, tset, np_params) = _decode_case(name, models)
    japi, jset = jbuild(jcfg), _jax_settings()
    B, S, CACHE = 2, 20, 24
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (B, 4)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks).long()}
    if name == "t5":
        enc = rng.integers(0, jcfg.vocab_size, (B, 10)).astype(np.int32)
        jbatch["enc_tokens"] = jnp.asarray(enc)
        tbatch["enc_tokens"] = torch.from_numpy(enc).long()
    jl, jcache = jax.jit(lambda p, b: japi.prefill(p, b, jset,
                                                   cache_len=CACHE))(
        np_params, jbatch)
    jdec = jax.jit(lambda p, c, b, pos: japi.decode_step(p, c, b, pos,
                                                         jset))
    with torch.inference_mode():
        tl, tcache = api.prefill(params, tbatch, tset, cache_len=CACHE)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        for t in range(4):
            pos = (np.full((B,), S + t, np.int32) if t % 2 == 0
                   else np.array(S + t, np.int32))
            jl, jcache = jdec(np_params, jcache,
                              {"tokens": jnp.asarray(nxt[:, t:t + 1])},
                              jnp.asarray(pos))
            tl = api.decode_step(params, tcache,
                                 {"tokens": torch.from_numpy(
                                     nxt[:, t:t + 1]).long()},
                                 torch.from_numpy(pos).long(), tset)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=TOL, atol=TOL)
    got, want = tree_flatten(tcache)[0], jax.tree.leaves(jcache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


# ------------------------------------------------------- the server

def _kvcfg(cls, quantum):
    return cls(page_tokens=8, max_seq_len=16, quantum=quantum,
               prefetch_depth=2, dtype="float32")


@pytest.fixture(scope="module")
def jax_served(models):
    """name -> (finished sequences by rid, schedule log) of JAX's server
    on the model's trace."""
    done = {}

    def get(name):
        if name not in done:
            jcfg, (_, _, _, np_params) = models(name)
            kind, quantum = JAX_RUN[name]
            spool, owned = (jserve.build_kv_spool("mem") if kind == "paged"
                            else (None, []))
            try:
                srv = jserve.make_server(
                    jbuild(jcfg), np_params, _jax_settings(),
                    _kvcfg(JKV, quantum), kind=kind, n_slots=2,
                    spool=spool, record_logits=True)
                jserve.synth_requests(srv, N_REQ, PROMPT, MAX_NEW,
                                      jcfg.vocab_size, 11)
                srv.run()
            finally:
                if spool is not None:
                    spool.close()
            done[name] = ({s.rid: s for s in srv.finished},
                          srv.schedule_log)
        return done[name]
    return get


def _serve_port(rt, kind, quantum=0, backend="mem", kv_dir=None):
    """The trace served through the benchmark's harness; returns
    (server, report, parking record)."""
    api, params, settings, _ = rt
    args = torch_serve_kv.parse_args([
        "--slots", "2", "--requests", str(N_REQ), "--prompt-len",
        str(PROMPT), "--max-new", str(MAX_NEW), "--cache-len", "16",
        "--page-tokens", "8", "--quantum", str(quantum),
        "--prefetch-depth", "2", "--seed", "11"])
    spool = (serve.build_kv_spool(backend, kv_dir, "byteplane")
             if kind == "paged" else None)
    try:
        srv, report, _, parking = torch_serve_kv.run_side(
            (api.cfg, api, params, settings), kind, args, spool)
    finally:
        if spool is not None:
            spool.close()
    return srv, report, parking


@pytest.mark.parametrize("name", ["mamba2", "recurrentgemma"])
def test_served_tokens_match_jax_and_paged_is_bitwise(models, jax_served,
                                                      name, tmp_path):
    _, rt = models(name)
    want, want_log = jax_served(name)
    sd, rd, _ = _serve_port(rt, "dense")
    runs = [_serve_port(rt, "paged"),
            _serve_port(rt, "paged", 3),
            _serve_port(rt, "paged", 3, "fs", str(tmp_path))]
    assert os.listdir(tmp_path) == []                # every blob dropped
    dense = {s.rid: s for s in sd.finished}
    assert set(dense) == set(want) and len(want) == N_REQ
    for rid in want:
        assert dense[rid].tokens == [int(t) for t in want[rid].tokens]
        np.testing.assert_allclose(np.stack(dense[rid].logits),
                                   np.stack(want[rid].logits), rtol=TOL,
                                   atol=TOL)
    cache = runs[0][0].cache
    assert cache.exact_prefill and any(cache.resident)
    assert cache.has_pages == (name == "recurrentgemma")
    for srv, rep, parking in runs:
        assert torch_serve_kv.bitwise_parity(srv, sd)
        assert not parking["mismatched"]
        if srv.kvcfg.quantum:
            assert rep.preemptions > 0
            assert parking["restores"] and rep.kv["restores"] == len(
                parking["restores"]) == rep.kv["evictions"]
            assert rep.kv["pages_evicted"] == rep.kv["pages_restored"]
            assert (rep.kv["pages_evicted"] > 0) == cache.has_pages
            assert rep.kv["bytes_evicted"] == rep.kv["bytes_restored"] > 0
    if name == "recurrentgemma":
        assert runs[1][0].schedule_log == want_log


def test_encoder_decoder_is_not_served():
    api = build_model(dataclasses.replace(small_t5(128, 2), dtype="float32"))
    with pytest.raises(ValueError, match="encoder-decoder.*ROADMAP"):
        build_manager("dense", api, None, RunSettings(device="cpu"),
                      KVCacheConfig(page_tokens=8, max_seq_len=16), 2)


# ------------------------------------------------------- the scheduler

class _StubCache:
    """A KV manager without a model: a slot's logits row is a numpy draw
    seeded by its last token and position."""
    kind, can_evict, device_bytes, vocab = "paged", True, 0, 16

    def __init__(self, kvcfg, n_slots):
        self.kvcfg, self.n_slots = kvcfg, n_slots
        self.stats = types.SimpleNamespace(as_dict=lambda: {})
        self.pos = np.zeros(n_slots, np.int64)
        self.last = np.zeros(n_slots, np.int64)

    def _row(self, tok, pos):
        return np.random.default_rng(int(tok) * 1000 + int(pos)).normal(
            size=self.vocab).astype(np.float32)

    def start(self, seq, slot):
        seq.slot, seq.pos = slot, len(seq.prompt)
        self.pos[slot] = seq.pos
        return self._row(seq.prompt[-1], seq.pos)

    def bind_token(self, seq, tok):
        seq.last_tok = self.last[seq.slot] = tok

    def advance(self, seq, tok):
        seq.pos += 1
        seq.last_tok = self.last[seq.slot] = tok
        self.pos[seq.slot] = seq.pos

    def decode(self):
        return np.stack([self._row(t, p) for t, p in zip(self.last,
                                                          self.pos)])

    def restore(self, seq, slot):
        seq.slot = slot
        self.pos[slot], self.last[slot] = seq.pos, seq.last_tok

    def evict(self, seq):
        seq.slot = None

    def release(self, seq):
        seq.slot = None

    def fault_in(self, seq):
        pass

    def prefetch(self, seq):
        pass


def test_scheduler_eos_sample_and_clock_match_jax():
    """Second-best sampling, an eos token that retires some sequences
    early, quantum 2 over 2 slots and a fake clock: the same tokens,
    schedule log and report (latencies included) as JAX's server."""
    def run(server_cls, kv_cls):
        ticks = iter(np.arange(10_000) * 1e-3)
        srv = server_cls(
            _StubCache(kv_cls(page_tokens=4, max_seq_len=64, quantum=2,
                              prefetch_depth=1), 2),
            eos_id=3, sample=lambda row: int(np.argsort(row)[-2]),
            time_fn=lambda: float(next(ticks)))
        rng = np.random.default_rng(2)
        for _ in range(6):
            srv.submit(rng.integers(0, 16, int(rng.integers(2, 6))), 9)
        return srv, srv.run().as_dict()

    js, jr = run(JServer, JKV)
    ts, tr = run(Server, KVCacheConfig)
    assert ts.schedule_log == js.schedule_log
    got = {s.rid: s.tokens for s in ts.finished}
    want = {s.rid: [int(t) for t in s.tokens] for s in js.finished}
    assert got == want
    assert any(len(t) < 9 and t[-1] == 3 for t in got.values())
    assert {k: tr[k] for k in jr} == jr


def test_serve_kv_benchmark_checks_pass_on_cpu(tmp_path, capsys):
    out = tmp_path / "serve.json"
    assert torch_serve_kv.main(["--device", "cpu", "--quick", "--check",
                                "--kv-backend", "mem", "--out",
                                str(out)]) == 0
    assert "all checks passed" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert all(doc["checks"].values()) and doc["device_name"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_serve_kv.main(["--quick"])


def test_serve_cli_eos_id_retires_early():
    """`--eos-id` reaches the Server through `make_server`: each request
    stops at its first sampled eos, and its tokens up to there are the
    ones it generates without the flag."""
    argv = ["--arch", "small-gpt", "--device", "cpu", "--attn-impl",
            "torch", "--cache", "dense", "--batch", "2", "--requests", "4",
            "--prompt-len", "8", "--max-new", "6", "--cache-len", "16"]
    rt = serve.build_runtime("small-gpt", 0, device="cpu",
                             attn_impl="torch")
    free, _ = serve.run(serve.parse_args(argv), rt)
    eos = free.finished[0].tokens[2]
    stopped, report = serve.run(serve.parse_args(argv + ["--eos-id",
                                                         str(eos)]), rt)
    want = {s.rid: s.tokens[:s.tokens.index(eos) + 1] if eos in s.tokens
            else s.tokens for s in free.finished}
    assert {s.rid: s.tokens for s in stopped.finished} == want
    assert report.generated_tokens == sum(map(len, want.values())) < sum(
        len(s.tokens) for s in free.finished)
