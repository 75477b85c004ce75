"""The port's storage data plane and spool: RSA2 serde round trips, blob
interop with the JAX package's serde and codecs in both directions, the
fs and mem backends, and the lease semantics serving relies on
(offload -> consume bitwise, forwarding of a pending store, prefetch,
close leaves the backend empty, unknown stages raise), and a dropped
record's late store never overwrites the next step's blob of its key."""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import SpoolIoConfig
from repro_torch.core import spool as spool_mod
from repro_torch.core.spool import (ActivationSpool, SpoolLoadError,
                                    build_spool)
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.io import (FilesystemBackend, HostMemoryBackend,
                            deserialize_leaves, encode_parts,
                            serialize_leaves, serialize_parts, unpack)
from repro_torch.io.codecs import pack

CODECS = ("raw", "zlib", "byteplane")


def _leaves(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((3, 5), generator=g),
            torch.randn((4, 8), generator=g).bfloat16(),
            torch.tensor(2.5),                              # 0-d
            torch.zeros((0, 7)),                            # empty
            torch.arange(6, dtype=torch.int32).reshape(2, 3),
            np.arange(4, dtype=np.float64)]                 # numpy leaf


def _same(a, b):
    a = torch.as_tensor(a)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


def test_serde_roundtrip_bitwise():
    leaves = _leaves()
    out = deserialize_leaves(serialize_leaves(leaves))
    assert len(out) == len(leaves)
    for a, b in zip(leaves, out):
        _same(a, b)
    with pytest.raises(ValueError, match="truncated"):
        deserialize_leaves(serialize_leaves(leaves)[:-3])


@pytest.mark.parametrize("codec", CODECS)
def test_codec_container_roundtrip(codec):
    leaves = _leaves(1)
    blob = b"".join(bytes(p) if isinstance(p, memoryview) else p
                    for p in encode_parts(serialize_parts(leaves), codec))
    for a, b in zip(leaves, deserialize_leaves(unpack(blob))):
        _same(a, b)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blob_interop_with_jax(codec, dtype):
    """A blob written by the port reads in the JAX package, and the
    reverse, bit for bit."""
    pytest.importorskip("ml_dtypes")
    from repro.io import codecs as jcodecs
    from repro.io import serde as jserde
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 4, 8)).astype(np.float32)
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        t = t.bfloat16()
    bits16 = (lambda a: a.view(torch.int16).numpy()) \
        if dtype == "bfloat16" else (lambda a: a.numpy())
    # port -> JAX
    blob = pack(serialize_leaves([t, t[:2]]), codec)
    got = jserde.deserialize_leaves(jcodecs.unpack(blob))
    assert [str(g.dtype) for g in got] == [dtype, dtype]
    np.testing.assert_array_equal(got[0].view(np.int16 if dtype ==
                                              "bfloat16" else np.float32),
                                  bits16(t))
    # JAX -> port
    import ml_dtypes
    arr = x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x
    jblob = jcodecs.pack(jserde.serialize_leaves([arr]), codec)
    (back,) = deserialize_leaves(unpack(jblob))
    assert back.dtype == t.dtype
    np.testing.assert_array_equal(bits16(back), bits16(t))


@pytest.mark.parametrize("kind", ["fs", "mem"])
def test_backends(kind, tmp_path):
    be = (FilesystemBackend(str(tmp_path)) if kind == "fs"
          else HostMemoryBackend())
    be.write_parts("a", [b"xy", memoryview(b"z")])
    be.write_parts("b", [b"123"])
    assert be.read("a") == b"xyz" and be.keys() == ["a", "b"]
    be.delete("a")
    be.delete("missing")                     # missing-tolerant
    assert be.keys() == ["b"]
    with pytest.raises(FileNotFoundError):
        be.read("a")
    assert be.stats.bytes_written == 6 and be.stats.num_writes == 2
    if kind == "fs":
        assert sorted(os.listdir(tmp_path)) == ["b.act"]


def test_tree_flatten_sorted_and_roundtrip():
    tree = {"b": [1, (2, 3)], "a": {"y": 4, "x": 5}}
    leaves, d = tree_flatten(tree)
    assert leaves == [5, 4, 1, 2, 3]          # jax.tree order
    assert tree_unflatten(d, leaves) == tree


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"0.b0": {"k": torch.randn((2, 4, 3, 8), generator=g).bfloat16(),
                     "v": torch.randn((2, 4, 3, 8), generator=g)}}


def _eq_tree(a, b):
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        _same(x, y)


@pytest.mark.parametrize("backend", ["fs", "mem"])
@pytest.mark.parametrize("codec", ["raw", "byteplane"])
def test_lease_offload_consume_bitwise(backend, codec):
    spool = build_spool(SpoolIoConfig(backend=backend, codec=codec),
                        min_offload_elements=0)
    try:
        tx = spool.lease("kv0")
        trees = {j: _tree(j) for j in range(4)}
        for j, t in trees.items():
            tx.offload(j, t)
        spool.wait_io()                      # stores land: reads, not forwards
        assert sorted(spool.backend.keys()) == [f"kv0_s{j}" for j in range(4)]
        tx.prefetch(1)
        tx.prefetch("never")                 # unknown stage: ignored
        for j in range(4):
            _eq_tree(tx.consume(j), trees[j])
        assert spool.stats.num_loads == 4 and spool.backend.keys() == []
        with pytest.raises(KeyError):
            tx.consume(0)
        tx.close()
    finally:
        spool.close()


class _SlowBackend(HostMemoryBackend):
    """Holds every write until released, so stores stay pending."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Event()

    def _write_parts(self, key, parts):
        self.gate.wait(10)
        super()._write_parts(key, parts)


def test_forwarding_while_store_pending():
    be = _SlowBackend()
    spool = ActivationSpool(be, store_threads=1, load_threads=1,
                            min_offload_elements=0)
    try:
        tx = spool.lease("kv1")
        a, b = _tree(1), _tree(2)
        tx.offload(0, a)                     # the worker blocks on this one
        tx.offload(1, b)                     # still queued behind it
        got = tx.consume(1)                  # forwarded, store cancelled
        _eq_tree(got, b)
        assert got["0.b0"]["k"] is b["0.b0"]["k"]
        assert spool.stats.stores_canceled == 1
        assert spool.stats.bytes_forwarded > 0
        be.gate.set()
        _eq_tree(tx.consume(0), a)
        tx.close()
        spool.wait_io()
        assert be.keys() == [] and spool.stats.num_loads == 0
    finally:
        be.gate.set()
        spool.close()


class _SlowFirstWrite(FilesystemBackend):
    """The first blob written takes `delay` seconds to land."""

    def __init__(self, directory, delay):
        super().__init__(directory)
        self.delay, self.writes = delay, 0
        self.started = threading.Event()

    def _write_parts(self, key, parts):
        self.writes += 1
        if self.writes == 1:
            self.started.set()
            time.sleep(self.delay)
        super()._write_parts(key, parts)


def test_a_dropped_store_never_overwrites_a_newer_blob_of_its_key(tmp_path):
    """Lease keys recur every step: a record dropped while its store is
    writing (forwarded in the step's backward) must not land its stale
    blob over the next step's blob of the same key."""
    be = _SlowFirstWrite(str(tmp_path), delay=0.5)
    spool = ActivationSpool(be, store_threads=2, load_threads=1,
                            min_offload_elements=0)
    try:
        old, new = torch.zeros(1000), torch.ones(1000)
        tx = spool.step("mb0")
        tx.offload(0, [old])
        be.started.wait(10)
        _same(tx.fetch(0)[0], old)          # forwarded from the host copy
        tx.close()                          # dropped while writing
        tx = spool.step("mb0")
        tx.offload(0, [new])                # the next step, the same key
        spool.wait_io()                     # both stores have landed
        assert spool.stats.num_stores == 2
        got = tx.fetch(0)[0]
        assert spool.stats.num_loads == 1
        _same(got, new)
        tx.close()
        spool.wait_io()
        assert be.keys() == []
    finally:
        spool.close()


class _LateRegisterCond(threading.Condition):
    """A store job's condition that holds its store worker up once, just
    after the release that follows the job's start: the moment between a
    store starting and it registering its key."""

    def __init__(self, job, delay):
        super().__init__()
        self.job, self.delay = job, delay
        self.started = threading.Event()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if (not self.started.is_set() and self.job.state == spool_mod.RUNNING
                and threading.current_thread().name.startswith(
                    "spool-store")):
            self.started.set()
            time.sleep(self.delay)
        return out


def test_a_store_held_up_as_it_starts_lands_before_the_next(monkeypatch):
    """A store worker held up right after its store starts, while its
    record is dropped and the next step's store of the key runs, still
    lands first: the blob left under the key is the newer one."""
    first = []

    class _Job(spool_mod._Job):
        def __init__(self, key, arrays, kind, event=None):
            super().__init__(key, arrays, kind, event)
            if kind == "store" and not first:
                self.cond = _LateRegisterCond(self, 0.3)
                first.append(self)

    monkeypatch.setattr(spool_mod, "_Job", _Job)
    spool = ActivationSpool(HostMemoryBackend(), store_threads=2,
                            load_threads=1, min_offload_elements=0)
    try:
        old, new = torch.zeros(1000), torch.ones(1000)
        tx = spool.step("mb0")
        tx.offload(0, [old])
        assert first[0].cond.started.wait(10)
        tx.close()                          # dropped as its store starts
        tx = spool.step("mb0")
        tx.offload(0, [new])                # the next step, the same key
        spool.wait_io()
        assert spool.stats.num_stores == 2
        _same(tx.fetch(0)[0], new)
        assert spool.stats.num_loads == 1
        tx.close()
        spool.wait_io()
        assert spool.backend.keys() == []
    finally:
        spool.close()


class _JitteryBackend(HostMemoryBackend):
    """Writes land after a random 0-3 ms, so stores of one key race."""

    def __init__(self, seed=0):
        super().__init__()
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()

    def _write_parts(self, key, parts):
        with self._rng_lock:
            delay = self._rng.uniform(0, 3e-3)
        time.sleep(delay)
        super()._write_parts(key, parts)


def test_stores_of_one_key_land_in_order_under_stress():
    """More store workers than cores, a short switch interval, and every
    step reusing one key: each fetch returns its own step's tensor,
    forwarded or read back."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    spool = ActivationSpool(_JitteryBackend(), store_threads=32,
                            load_threads=4, min_offload_elements=0)
    try:
        rng = np.random.default_rng(1)
        deadline = time.monotonic() + 20
        for i in range(300):
            tx = spool.step("mb0")
            tx.offload(0, [torch.full((64,), float(i))])
            if rng.random() < 0.5:
                time.sleep(rng.uniform(0, 2e-3))
            assert torch.equal(tx.fetch(0)[0], torch.full((64,), float(i)))
            tx.close()
            assert time.monotonic() < deadline
        spool.wait_io()
        assert spool.stats.num_loads > 0 and spool.stats.bytes_forwarded > 0
        assert spool.backend.keys() == []
    finally:
        sys.setswitchinterval(old)
        spool.close()


def test_close_drops_everything(tmp_path):
    spool = build_spool(SpoolIoConfig(backend="fs",
                                      directory=str(tmp_path)),
                        min_offload_elements=0)
    tx = spool.lease("kv2")
    for j in range(3):
        tx.offload(j, _tree(j))
    tx.offload("st", {"r": torch.ones(3)})
    with pytest.raises(RuntimeError, match="already active"):
        spool.lease("kv2")
    tx.close()
    tx.close()                               # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        tx.offload(9, _tree(9))
    spool.close()
    spool.close()
    assert os.listdir(tmp_path) == []
    assert spool.live_keys() == []


def test_owned_temp_dir_removed_and_small_leaves_kept():
    spool = build_spool(SpoolIoConfig(backend="fs"),
                        min_offload_elements=64)
    d = spool.backend.directory
    tx = spool.lease("kv3")
    big, small = torch.randn(128), torch.randn(8)
    tx.offload(0, {"big": big, "small": small})
    spool.wait_io()
    assert spool.backend.keys() == ["kv3_s0"]
    got = tx.consume(0)
    assert got["small"] is small and torch.equal(got["big"], big)
    with pytest.raises(ValueError, match="not ported"):
        SpoolIoConfig(backend="striped").validate()
    spool.close()
    assert not os.path.exists(d)


@pytest.mark.parametrize("backend", ["fs", "mem"])
def test_lost_blob_raises_spool_load_error(backend):
    """A blob that vanished after its store landed fails the fetch with
    SpoolLoadError (chained to the backend's error), the one error the
    training engine answers with a recompute."""
    spool = build_spool(SpoolIoConfig(backend=backend),
                        min_offload_elements=0)
    try:
        tx = spool.lease("lost")
        tx.offload(0, _tree(0))
        spool.wait_io()
        spool.backend.delete(tx.key(0))
        with pytest.raises(SpoolLoadError) as info:
            tx.fetch(0)
        assert isinstance(info.value.__cause__, (OSError, KeyError))
        tx.close()
    finally:
        spool.close()


def test_reload_keeps_permuted_layouts_and_packs_views_with_gaps():
    """A transposed leaf comes back with its strides (backward kernels see
    the layout they were saved with); a slice with gaps comes back
    contiguous, holding only its own elements, not its base's extent."""
    spool = build_spool(SpoolIoConfig(backend="mem"), min_offload_elements=0)
    try:
        tx = spool.lease("lay")
        base = torch.randn(6, 5, 4)
        tr, gap = torch.randn(4, 7).t(), base[:, 2]
        tx.offload(0, {"tr": tr, "gap": gap})
        spool.wait_io()
        got = tx.consume(0)
        assert torch.equal(got["tr"], tr) and got["tr"].stride() == (1, 7)
        assert torch.equal(got["gap"], gap) and got["gap"].is_contiguous()
        assert got["gap"].untyped_storage().nbytes() == gap.numel() * 4
        assert spool.stats.num_loads == 1
    finally:
        spool.close()
