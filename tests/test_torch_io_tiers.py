"""The port's storage tiers (`repro_torch.io`: striped, tiered, aio, the
aligned buffer pool, the factory) held against the JAX package's
`repro.io`: the cases of tests/test_io_backends.py run over both
packages where the API is the same, plus checks across the packages
(byte-identical stripe chunk files, each package's blobs read back by the
other through `readinto` into a pool lease), the port's pooled load path
(a lease outlives its consumer, and on the card waits for the copy back
to the device) and serving over a striped KV spool, bitwise equal to the
dense cache. Small sizes, CPU."""
import os
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.io as jio  # noqa: E402
import repro.io.backends as jbackends  # noqa: E402
import repro_torch.io as tio  # noqa: E402
import repro_torch.io.backends as tbackends  # noqa: E402
from repro.configs.base import SpoolIoConfig as JIo  # noqa: E402
from repro.core.spool import ActivationSpool as JSpool  # noqa: E402
from repro_torch.configs import SpoolIoConfig as TIo  # noqa: E402
from repro_torch.core.spool import ActivationSpool as TSpool  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

BACKEND_KINDS = ["fs", "striped", "mem", "tiered", "aio"]
CODEC_NAMES = ["raw", "zlib", "byteplane"]


def _pkg(name):
    if name == "jax":
        return types.SimpleNamespace(
            name=name, io=jio, backends=jbackends, Spool=JSpool, Io=JIo,
            leaf=lambda a: a, arr=np.asarray)
    return types.SimpleNamespace(
        name=name, io=tio, backends=tbackends, Spool=TSpool, Io=TIo,
        leaf=torch.from_numpy, arr=lambda t: np.asarray(t))


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _pkg(request.param)


def make_backend(pkg, kind, tmp_path, **kw):
    io = pkg.io
    if kind == "fs":
        return io.FilesystemBackend(str(tmp_path / "fs"))
    if kind == "striped":
        return io.StripedBackend([str(tmp_path / f"s{i}") for i in range(3)],
                                 chunk_bytes=kw.get("chunk_bytes", 1 << 12))
    if kind == "mem":
        return io.HostMemoryBackend()
    if kind == "tiered":
        return io.TieredBackend(io.FilesystemBackend(str(tmp_path / "low")),
                                capacity_bytes=kw.get("capacity_bytes",
                                                      32 << 10))
    if kind == "aio":
        return io.AioBackend(str(tmp_path / "aio"),
                             queue_depth=kw.get("queue_depth", 4))
    raise AssertionError(kind)


def _tree(pkg, seed=0, n=3, shape=(64, 64)):
    rng = np.random.default_rng(seed)
    return [pkg.leaf(rng.normal(size=shape).astype(np.float32))
            for _ in range(n)]


def _equal(pkg, a, b):
    np.testing.assert_array_equal(np.asarray(pkg.arr(a)),
                                  np.asarray(pkg.arr(b)))


# ------------------------------------------------------- raw backend API


@pytest.mark.parametrize("kind", BACKEND_KINDS)
def test_backend_blob_roundtrip(pkg, kind, tmp_path):
    b = make_backend(pkg, kind, tmp_path)
    data = os.urandom(10_000)
    b.write("k", data)
    assert b.read("k") == data
    assert b.stats.bytes_written == len(data)
    assert b.stats.bytes_read == len(data)
    b.delete("k")
    with pytest.raises((FileNotFoundError, OSError)):
        b.read("k")
    b.delete("missing")
    b.close()


@pytest.mark.parametrize("kind", BACKEND_KINDS)
def test_backend_reports_tier_bandwidths(pkg, kind, tmp_path):
    b = make_backend(pkg, kind, tmp_path)
    b.write("k", b"x" * 4096)
    tiers = b.tier_bandwidths()
    assert len(tiers) >= 1 and all(t.write_bw > 0 for t in tiers)
    if kind == "tiered":
        assert tiers[0].capacity_bytes == b.capacity_bytes
        assert tiers[-1].capacity_bytes is None
    b.close()


@pytest.mark.parametrize("kind", BACKEND_KINDS)
def test_write_parts_matches_joined_write(pkg, kind, tmp_path):
    b = make_backend(pkg, kind, tmp_path)
    parts = [b"head", os.urandom(10_000), b"", os.urandom(3)]
    joined = b"".join(parts)
    b.write_parts("vec", [memoryview(p) for p in parts])
    b.write("join", joined)
    assert b.read("vec") == joined == b.read("join")
    assert b.size("vec") == len(joined)
    assert b.stats.bytes_written == 2 * len(joined)
    b.close()


@pytest.mark.parametrize("kind", BACKEND_KINDS)
def test_readinto_fills_caller_buffer(pkg, kind, tmp_path):
    b = make_backend(pkg, kind, tmp_path)
    data = os.urandom(20_000)
    b.write_parts("k", [memoryview(data)])
    pool = pkg.io.AlignedBufferPool()
    with pool.acquire(len(data)) as lease:
        mv = b.readinto("k", lease.mv)
        assert bytes(mv) == data
    with pytest.raises((ValueError, FileNotFoundError)):
        b.readinto("k", memoryview(bytearray(100)))
    with pytest.raises((FileNotFoundError, OSError)):
        b.readinto("missing", memoryview(bytearray(1 << 15)))
    pool.close()
    b.close()


@pytest.mark.parametrize("kind", ["fs", "striped", "tiered"])
def test_vectored_fs_paths_copy_nothing(pkg, kind, tmp_path):
    b = make_backend(pkg, kind, tmp_path, capacity_bytes=0)
    b.write_parts("k", pkg.io.serialize_parts(
        [pkg.leaf(np.arange(4096, dtype=np.float32))]))
    pool = pkg.io.AlignedBufferPool()
    with pool.acquire(b.size("k")) as lease:
        b.readinto("k", lease.mv)
    assert b.stats.bytes_copied == 0
    if kind == "tiered":
        assert b.lower.stats.bytes_copied == 0
    pool.close()
    b.close()


# ------------------------------------------------- spool over backends


@pytest.mark.parametrize("kind", BACKEND_KINDS)
@pytest.mark.parametrize("codec", CODEC_NAMES)
def test_spool_roundtrip_over_backend(pkg, kind, codec, tmp_path):
    spool = pkg.Spool(make_backend(pkg, kind, tmp_path), codec=codec,
                      min_offload_elements=16)
    trees = {f"k{i}": _tree(pkg, seed=i) for i in range(4)}
    for k, t in trees.items():
        spool.offload(k, t)
    spool.wait_io()
    assert spool.backend.stats.num_writes > 0
    for k in reversed(list(trees)):
        for a, b in zip(trees[k], spool.fetch(k)):
            _equal(pkg, a, b)
        spool.drop(k)
    spool.close()


@pytest.mark.parametrize("kind", BACKEND_KINDS)
def test_spool_forwarding_and_cancellation(pkg, kind, tmp_path):
    spool = pkg.Spool(make_backend(pkg, kind, tmp_path),
                      bandwidth_limit=1e6, store_threads=1,
                      min_offload_elements=16)
    t1, t2 = _tree(pkg, 1), _tree(pkg, 2)
    spool.offload("a", t1)
    spool.offload("b", t2)
    for a, b in zip(t2, spool.fetch("b")):
        _equal(pkg, a, b)
    assert spool.stats.bytes_forwarded > 0
    assert spool.stats.stores_canceled >= 1
    spool.wait_io()
    spool.close()


def test_spool_drop_during_inflight_store_leaks_nothing(pkg):
    backend = pkg.io.HostMemoryBackend()
    spool = pkg.Spool(backend, bandwidth_limit=2e6, store_threads=1,
                      min_offload_elements=16)
    spool.offload("a", _tree(pkg, 1))
    spool.offload("b", _tree(pkg, 2))
    spool.fetch("b")
    spool.fetch("a")
    spool.drop("a")
    spool.drop("b")
    spool.wait_io()
    assert backend.resident_bytes == 0
    spool.close()


def test_spool_key_reuse_after_orphaned_store(pkg):
    backend = pkg.io.HostMemoryBackend()
    spool = pkg.Spool(backend, bandwidth_limit=2e6, store_threads=1,
                      min_offload_elements=16)
    t_old, t_new = _tree(pkg, 1), _tree(pkg, 5)
    spool.offload("k", t_old)
    spool.fetch("k")
    spool.drop("k")
    spool.offload("k", t_new)
    spool.wait_io()
    for a, want in zip(spool.fetch("k"), t_new):
        _equal(pkg, a, want)
    spool.drop("k")
    spool.wait_io()
    assert backend.resident_bytes == 0
    spool.close()


def test_calibration_measures_every_tier(pkg, tmp_path):
    spool = pkg.Spool(make_backend(pkg, "tiered", tmp_path,
                                   capacity_bytes=1 << 20),
                      codec="zlib", min_offload_elements=16)
    spool.calibrate_backend(64 << 10)
    tiers = spool.planner_bandwidth()
    assert isinstance(tiers, list) and len(tiers) == 2
    assert all(0 < t.write_bw < float("inf") for t in tiers)
    assert tiers[0].write_bw <= spool.backend.tier_bandwidths()[0].write_bw
    spool.close()


# ----------------------------------------------------------- striping


def test_striped_balance_across_devices(pkg, tmp_path):
    dirs = [str(tmp_path / f"ssd{i}") for i in range(4)]
    b = pkg.io.StripedBackend(dirs, chunk_bytes=1 << 10)
    b.write("k", os.urandom(64 << 10))
    per_dev = b.per_device_write_bytes()
    assert len([n for n in per_dev if n > 0]) >= 2
    assert max(per_dev) - min(per_dev) <= b.chunk_bytes
    for d in dirs:
        assert any(f.startswith("k.c") for f in os.listdir(d))
    b.delete("k")
    assert all(not os.listdir(d) for d in dirs)


def test_striped_rewrite_with_fewer_chunks_prunes_tail(pkg, tmp_path):
    dirs = [str(tmp_path / f"ssd{i}") for i in range(2)]
    b = pkg.io.StripedBackend(dirs, chunk_bytes=1 << 10)
    b.write("k", os.urandom(5 << 10))
    small = os.urandom(2 << 10)
    b.write("k", small)
    assert pkg.io.StripedBackend(dirs, chunk_bytes=1 << 10).read("k") \
        == small
    b.delete("k")
    assert all(not os.listdir(d) for d in dirs)


def test_striped_read_without_manifest(pkg, tmp_path):
    dirs = [str(tmp_path / f"ssd{i}") for i in range(2)]
    data = os.urandom(10_000)
    pkg.io.StripedBackend(dirs, chunk_bytes=1 << 10).write("k", data)
    assert pkg.io.StripedBackend(dirs, chunk_bytes=1 << 10).read("k") == data


# ------------------------------------------------------------- tiering


def test_tiered_eviction_respects_budget(pkg):
    lower = pkg.io.HostMemoryBackend()
    budget = 64 << 10
    b = pkg.io.TieredBackend(lower, capacity_bytes=budget)
    blobs = {f"k{i}": os.urandom(16 << 10) for i in range(10)}
    for k, v in blobs.items():
        b.write(k, v)
        assert b.resident_bytes <= budget
    assert b.evictions > 0
    assert "k9" in b.upper and "k0" not in b.upper
    assert lower.read("k0") == blobs["k0"]
    for k, v in blobs.items():
        assert b.read(k) == v


def test_tiered_oversize_and_rewrites(pkg):
    lower = pkg.io.HostMemoryBackend()
    b = pkg.io.TieredBackend(lower, capacity_bytes=1 << 10)
    big = os.urandom(1 << 20)
    b.write("big", big)
    assert b.resident_bytes == 0 and b.read("big") == big
    b.write("k", b"small")
    b.write("k", big)                 # oversize rewrite of a resident key
    assert b.read("k") == big and b.resident_bytes == 0
    b.write("k", b"fresh-small")      # small again: the lower copy goes
    assert b.read("k") == b"fresh-small"
    b.delete("k")
    b.delete("big")
    assert b.resident_bytes == 0 and lower.resident_bytes == 0


def test_tiered_concurrent_spill_and_delete(pkg):
    lower = pkg.io.HostMemoryBackend()
    b = pkg.io.TieredBackend(lower, capacity_bytes=32 << 10)
    for i in range(8):
        b.write(f"k{i}", os.urandom(8 << 10))
    for i in range(8):
        b.delete(f"k{i}")
    assert b.resident_bytes == 0 and lower.resident_bytes == 0


# ------------------------------------------------------ pool and aio


def test_bufpool_alignment_reuse_and_trim(pkg):
    pool = pkg.io.AlignedBufferPool(alignment=4096, max_bytes=1 << 20)
    a = pool.acquire(10_000)
    assert a.capacity % 4096 == 0 and a.capacity >= 10_000
    assert np.frombuffer(a.mv, np.uint8).ctypes.data % 4096 == 0
    a.release()
    a.release()
    b = pool.acquire(9_000)
    assert pool.hits == 1 and pool.misses == 1
    b.release()
    assert pool.free_bytes == b.capacity
    pool.close()
    assert pool.free_bytes == 0
    pool = pkg.io.AlignedBufferPool(alignment=4096, max_bytes=8192)
    for lease in [pool.acquire(8192) for _ in range(3)]:
        lease.release()
    assert pool.trimmed == 2 and pool.free_bytes <= 8192
    pool.close()
    for bad in (3000, 1 << 20):
        with pytest.raises(ValueError):
            pkg.io.AlignedBufferPool(alignment=bad)


def test_a_registered_pool_keeps_what_it_had_leased_at_once(monkeypatch):
    """A pool registered with CUDA (a stand-in runtime here) keeps idle
    as many bytes as it had leased at once, above its `max_bytes`, so a
    second round of the same leases registers nothing new; an
    unregistered pool trims to `max_bytes` as the JAX pool does."""
    import repro_torch.io.bufpool as tbufpool

    class _Cudart:
        class cudaError:
            success = 0

        def __init__(self):
            self.registered, self.unregistered = 0, 0

        def cudaHostRegister(self, addr, n, flags):
            self.registered += 1
            return 0

        def cudaHostUnregister(self, addr):
            self.unregistered += 1

    rt = _Cudart()
    monkeypatch.setattr(tbufpool, "_cudart", lambda: rt)
    for cuda in (False, True):
        pool = tio.AlignedBufferPool(alignment=4096, max_bytes=8192)
        if cuda:
            pool.register_cuda()
        for _ in range(2):
            for lease in [pool.acquire(60_000) for _ in range(3)]:
                lease.release()
        assert pool.peak_leased_bytes == 3 * 65536
        if cuda:
            assert (pool.misses, pool.hits, pool.trimmed) == (3, 3, 0)
            assert pool.idle_cap == pool.free_bytes == 3 * 65536
            assert rt.registered == 3 and rt.unregistered == 0
            pool.acquire(60_000).release()
            assert pool.free_bytes <= pool.idle_cap
        else:
            assert (pool.misses, pool.trimmed) == (6, 6)
            assert pool.idle_cap == 8192 and pool.free_bytes == 0
        pool.close()
    assert rt.unregistered == 3


@pytest.mark.parametrize("direct", [None, False])
def test_aio_roundtrips(pkg, direct, tmp_path):
    b = pkg.io.AioBackend(str(tmp_path / "aio"), direct=direct)
    for n in (0, 1, 511, 4096, 4097, 10_000, 70_001):
        data = os.urandom(n)
        b.write("k", data)
        assert b.size("k") == n and b.read("k") == data
    data = os.urandom(10_000)
    b.write_parts("k", [memoryview(data[:4000]), memoryview(data[4000:])])
    raw = bytearray(len(data) + 1)
    assert bytes(b.readinto("k", memoryview(raw)[1:])) == data  # unaligned
    b.write("k", os.urandom(50_000))
    b.write("k", data)                       # a shorter rewrite truncates
    assert b.size("k") == len(data) and b.read("k") == data
    b.close()
    one = pkg.io.AioBackend(str(tmp_path / "aio1"), queue_depth=1)
    one.write("k", data)
    assert one.read("k") == data
    one.close()


def test_port_aio_writes_one_aligned_part_without_staging(tmp_path):
    """The port's spool lays a raw blob out in one pool lease: aio writes
    it from there (only its last partial block is bounced), where any
    other part list is staged once, as the JAX backend stages every
    blob."""
    b = tio.AioBackend(str(tmp_path / "aio"))
    pool = tio.AlignedBufferPool()
    data = os.urandom(3 * 4096 + 123)
    with pool.acquire(len(data)) as lease:
        lease.mv[:len(data)] = data
        b.write_parts("k", [lease.mv[:len(data)]])
    assert b.read("k") == data
    assert b.stats.bytes_copied == len(data)       # the read's own copy
    b.write_parts("j", [memoryview(data[:5]), memoryview(data[5:])])
    assert b.stats.bytes_copied == 2 * len(data)   # one staging copy
    pool.close()
    b.close()


@pytest.mark.parametrize("pkgname,mod", [("jax", "repro.io.backends"),
                                         ("torch", "repro_torch.io.backends")])
def test_fs_write_is_atomic_and_failure_cleans_temp(pkgname, mod, tmp_path,
                                                    monkeypatch):
    pkg = _pkg(pkgname)
    b = pkg.io.FilesystemBackend(str(tmp_path / "fs"))
    blob = pkg.io.serialize_leaves([pkg.leaf(np.arange(1024,
                                                        dtype=np.float32))])
    b.write("k", blob)
    assert os.listdir(str(tmp_path / "fs")) == ["k.act"]
    with open(str(tmp_path / "fs" / "torn.act"), "wb") as f:
        f.write(blob[:len(blob) // 2])
    with pytest.raises(ValueError):
        pkg.io.deserialize_leaves(pkg.io.unpack(b.read("torn")))
    b.delete("k")
    b.delete("torn")

    def boom(fd, parts, offset=0):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(pkg.backends, "pwritev_all", boom)
    with pytest.raises(OSError):
        b.write("k", b"x" * 1000)
    assert os.listdir(str(tmp_path / "fs")) == []


# ----------------------------------------------- factory / spec strings


def test_backend_from_spec_and_parse_bytes(pkg, tmp_path):
    io, base = pkg.io, str(tmp_path)
    assert io.parse_bytes("64kb") == 64 << 10
    assert io.parse_bytes("1.5mb") == int(1.5 * (1 << 20))
    assert io.parse_bytes("4096") == 4096
    assert isinstance(io.backend_from_spec("fs", base_dir=base),
                      io.FilesystemBackend)
    assert isinstance(io.backend_from_spec("mem"), io.HostMemoryBackend)
    s = io.backend_from_spec("striped@4", base_dir=base)
    assert isinstance(s, io.StripedBackend) and len(s.directories) == 4
    t = io.backend_from_spec("tiered:64kb,mem", base_dir=base)
    assert isinstance(t, io.TieredBackend) and t.capacity_bytes == 64 << 10
    assert isinstance(t.lower, io.HostMemoryBackend)
    a = io.backend_from_spec("aio@8", base_dir=base)
    assert isinstance(a, io.AioBackend) and a.queue_depth == 8
    a2 = io.backend_from_spec(f"aio:{base}/dio", base_dir=base)
    assert a2.directory == f"{base}/dio"
    with pytest.raises(KeyError):
        io.backend_from_spec("nvram", base_dir=base)
    for b in (s, t, a, a2):
        b.close()


def test_build_backend_from_config(pkg, tmp_path):
    io = pkg.io
    ioc = pkg.Io(backend="aio", queue_depth=2, alignment=512,
                 pool_bytes=1 << 20).validate()
    b = io.build_backend(ioc, default_dir=str(tmp_path))
    assert isinstance(b, io.AioBackend)
    assert b.queue_depth == 2 and b.alignment == 512
    assert b.pool.alignment == 512
    b.close()
    ioc = pkg.Io(backend="tiered", stripe_dirs=(str(tmp_path / "a"),
                                                str(tmp_path / "b")),
                 host_mem_budget_bytes=1 << 20).validate()
    b = io.build_backend(ioc, default_dir=str(tmp_path))
    assert isinstance(b, io.TieredBackend)
    assert isinstance(b.lower, io.StripedBackend)


def test_port_config_keeps_refusing_later_slices():
    # the jit engine's host offload, the optimizer overlap and the
    # meshes' replica dedup switch are ported
    for kw in ({"host_offload": "opt_state"},
               {"host_offload": "activations"}, {"opt_overlap": True},
               {"dedupe_replicas": False}):
        TIo(**kw).validate()
        JIo(**kw).validate()
    for kw in ({"host_offload": "optimizer"}, {"opt_overlap": "sync"},
               {"dedupe_replicas": "no"}, {"backend": "nvram"},
               {"alignment": 3000}, {"retry_attempts": 0}):
        with pytest.raises(ValueError):
            TIo(**kw).validate()


# ------------------------------------------------ across the packages


def test_striped_chunk_files_identical_across_packages(tmp_path):
    """crc32 placement: the same blobs through each package's striped
    backend leave byte-identical chunk files in the same directories."""
    rng = np.random.default_rng(3)
    blobs = {f"mb0_s{i}": rng.integers(0, 256, n, np.uint8).tobytes()
             for i, n in enumerate((100, 5000, 17_000, 40_000))}
    files, per_dev = {}, {}
    for name, io in (("jax", jio), ("torch", tio)):
        dirs = [str(tmp_path / name / f"d{i}") for i in range(3)]
        b = io.StripedBackend(dirs, chunk_bytes=4096)
        for k, v in blobs.items():
            b.write_parts(k, [memoryview(v)])
        files[name] = {}
        for i, d in enumerate(dirs):
            for f in os.listdir(d):
                with open(os.path.join(d, f), "rb") as fh:
                    files[name][i, f] = fh.read()
        per_dev[name] = b.per_device_write_bytes()
    assert files["jax"] == files["torch"] and len(files["jax"]) > 4
    assert per_dev["jax"] == per_dev["torch"]


@pytest.mark.parametrize("codec", CODEC_NAMES)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_blobs_cross_packages_through_readinto(codec, writer, tmp_path):
    """A blob either package writes (its spool's own serde and codec
    container, on its striped backend) is read back by the other
    package's striped backend with `readinto` into a pool lease, and
    deserializes to the same leaves, zero-copy."""
    w, r = _pkg(writer), _pkg("torch" if writer == "jax" else "jax")
    dirs = [str(tmp_path / f"d{i}") for i in range(2)]
    rng = np.random.default_rng(4)
    leaves = [rng.normal(size=(33, 7)).astype(np.float32),
              rng.integers(-5, 5, (9,)).astype(np.int64)]
    wb = w.io.StripedBackend(dirs, chunk_bytes=1024)
    wb.write_parts("k", w.io.encode_parts(w.io.serialize_parts(
        [w.leaf(a) for a in leaves]), codec))
    rb = r.io.StripedBackend(dirs, chunk_bytes=1024)
    pool = r.io.AlignedBufferPool()
    with pool.acquire(rb.size("k")) as lease:
        blob = rb.readinto("k", lease.mv)
        out = r.io.deserialize_leaves(r.io.unpack(blob), copy=False)
        for a, got in zip(leaves, out):
            np.testing.assert_array_equal(a, np.asarray(got))
        del out, blob
    pool.close()


# --------------------------------------------- the port's pooled loads


class _Event:
    """A stand-in for a CUDA event: done once set."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_a_loads_lease_outlives_its_consumer(tmp_path):
    """A fetched record's pooled buffer stays its own until the record is
    dropped: loads issued meanwhile get other buffers, and its bytes are
    untouched; after the drop the next load reuses it. On the card the
    lease also waits for the copy back to the device (its event): a
    release while that copy may still read it is deferred until the
    event completes."""
    spool = TSpool(tio.FilesystemBackend(str(tmp_path)), store_threads=1,
                   load_threads=1, min_offload_elements=0,
                   pool_bytes=1 << 22)
    try:
        rng = np.random.default_rng(5)
        a, b = (torch.from_numpy(rng.normal(size=(256, 64)).astype(
            np.float32)) for _ in range(2))
        tx = spool.step("mb0")
        tx.offload(0, [a])
        tx.offload(1, [b])
        spool.wait_io()
        assert torch.equal(tx.fetch(1)[0], b)
        rec = spool._records[tx.key(1)]
        lease, held = rec["load_lease"], rec["loaded"][0]
        assert lease is not None
        # a slow consumer: stage 0 loads while stage 1 is still held
        got = tx.fetch(0)[0]
        assert torch.equal(got, a)
        assert rec["load_lease"] is lease and torch.equal(held, b)
        assert spool._records[tx.key(0)]["load_lease"] is not lease
        hits = spool.pool.hits
        tx.drop(1)
        tx.drop(0)
        tx.offload(2, [a])
        spool.wait_io()
        assert torch.equal(tx.fetch(2)[0], a)
        assert spool.pool.hits > hits          # a dropped lease came back
        tx.close()
        # the card's rule, with a stand-in event
        ev = _Event()
        held = spool.pool.acquire(1000)
        misses = spool.pool.misses
        spool._release_after(held, ev)
        spool._reap()
        again = spool.pool.acquire(1000)       # not the pending buffer
        assert spool.pool.misses == misses + 1
        ev.done = True
        spool._reap()
        third = spool.pool.acquire(1000)       # now it is back
        assert spool.pool.hits >= hits + 2
        again.release()
        third.release()
    finally:
        spool.close()


class _GatedFs(tio.FilesystemBackend):
    """Holds every write until the gate opens, so later stores queue."""

    def __init__(self, directory):
        super().__init__(directory)
        import threading
        self.gate = threading.Event()

    def _write_parts(self, key, parts):
        self.gate.wait(10)
        super()._write_parts(key, parts)


def test_a_queued_stores_lease_waits_for_its_copy_off_the_card(tmp_path):
    """A record dropped while its store is still queued, and never
    fetched, cancels the store; its lease may still be the target of the
    device-to-host copy (a stand-in event here), so it goes back to the
    pool only after that copy's event has completed."""
    be = _GatedFs(str(tmp_path))
    spool = TSpool(be, store_threads=1, load_threads=1,
                   min_offload_elements=0, pool_bytes=1 << 22)
    events = []
    real = spool._to_host

    def to_host(leaves):
        host, _, _, blob = real(leaves)
        ev = _Event()
        events.append(ev)
        return host, ev, spool.pool.acquire(1000), blob

    spool._to_host = to_host
    try:
        x = torch.arange(256, dtype=torch.float32)
        tx = spool.step("mb0")
        tx.offload(0, [x])              # the worker blocks on this one
        tx.offload(1, [x + 1])          # still queued behind it
        rec = spool._records[tx.key(1)]
        assert rec["job"].lease is not None
        misses = spool.pool.misses
        tx.drop(1)                      # cancelled, its copy still running
        assert spool.stats.stores_canceled == 1
        spool._reap()
        held = spool.pool.acquire(1000)  # not the pending buffer
        assert spool.pool.misses == misses + 1
        hits = spool.pool.hits
        events[1].done = True
        spool._reap()
        again = spool.pool.acquire(1000)  # now it is back
        assert spool.pool.hits == hits + 1
        held.release()
        again.release()
        be.gate.set()
        tx.close()
        spool.wait_io()
    finally:
        be.gate.set()
        spool.close()


def test_cpu_fetch_copies_pool_views_once(tmp_path):
    """On the CPU a raw load deserializes views over its lease, and fetch
    hands out copies (they become the graph's saved tensors); a decoding
    codec's fresh memory goes back to the pool at once and its leaves
    come out as they are."""
    for codec in ("raw", "zlib"):
        spool = TSpool(tio.FilesystemBackend(str(tmp_path / codec)),
                       codec=codec, min_offload_elements=0)
        try:
            x = torch.arange(4096, dtype=torch.float32)
            tx = spool.step("mb0")
            tx.offload(0, [x])
            spool.wait_io()
            got = tx.fetch(0)[0]
            rec = spool._records[tx.key(0)]
            assert torch.equal(got, x)
            if codec == "raw":
                assert rec["load_lease"] is not None
                assert got.data_ptr() != rec["loaded"][0].data_ptr()
            else:
                assert rec["load_lease"] is None
                assert got.data_ptr() == rec["loaded"][0].data_ptr()
            tx.close()
        finally:
            spool.close()


def test_header_parts_match_serialize_parts():
    """The raw store path writes header_parts + the leaves' bytes: the
    same blob serialize_parts gives, and the JAX package reads."""
    leaves = [torch.randn(3, 4), torch.randn(5).bfloat16(),
              torch.tensor([True, False]), torch.zeros(0, 2,
                                                       dtype=torch.int64),
              torch.tensor(1.5)]
    head = b"".join(bytes(p) for p in tio.serde.header_parts(leaves))
    blob = b"".join(bytes(p) for p in tio.serialize_parts(leaves))
    assert blob.startswith(head)
    body = b"".join(t.reshape(-1).view(torch.uint8).numpy().tobytes()
                    for t in leaves)
    assert head + body == blob
    out = jio.deserialize_leaves(blob)
    np.testing.assert_array_equal(out[0], leaves[0].numpy())


def test_serve_over_a_striped_kv_spool_is_bitwise_dense(tmp_path):
    from repro_torch.launch import serve
    base = ["--arch", "small-gpt", "--device", "cpu", "--attn-impl", "torch",
            "--requests", "5", "--batch", "2", "--prompt-len", "20",
            "--max-new", "6", "--cache-len", "32", "--page-tokens", "8",
            "--quantum", "2"]
    rt = serve.build_runtime("small-gpt", 0, device="cpu", attn_impl="torch")
    kv = str(tmp_path / "kv")
    sp, rp = serve.run(serve.parse_args(base + ["--kv-backend", "striped",
                                                "--kv-dir", kv]), rt,
                       record_logits=True)
    sd, _ = serve.run(serve.parse_args(base + ["--cache", "dense"]), rt,
                      record_logits=True)
    assert rp.kv["pages_evicted"] == rp.kv["pages_restored"] > 0
    p = {s.rid: s for s in sp.finished}
    d = {s.rid: s for s in sd.finished}
    assert set(p) == set(d) and len(p) == 5
    for rid in p:
        assert p[rid].tokens == d[rid].tokens
        for x, y in zip(p[rid].logits, d[rid].logits):
            np.testing.assert_array_equal(x, y)
    assert sorted(os.listdir(kv)) == ["stripe0", "stripe1"]
    assert all(not os.listdir(os.path.join(kv, s)) for s in os.listdir(kv))


def test_train_cli_takes_every_storage_flag(tmp_path, capsys):
    """The JAX CLI's storage, pool, retry and --cache-* flags reach the
    spool; the flags of later slices are still refused."""
    import json
    from repro_torch.launch import train
    base = ["--arch", "small-gpt", "--device", "cpu", "--steps", "1",
            "--batch", "2", "--seq", "32", "--strategy", "spool",
            "--min-offload", "0"]
    dirs = f"{tmp_path}/a,{tmp_path}/b"
    train.main(base + ["--spool-backend", "striped", "--stripe-dirs", dirs,
                       "--spool-pool-mb", "64", "--spool-align", "4096",
                       "--retry-attempts", "2", "--retry-backoff-ms", "1"])
    out = capsys.readouterr().out
    assert "stripe write balance" in out and "pool hits" in out
    metrics = str(tmp_path / "m.jsonl")
    train.main(base + ["--cache-managed", "--cache-host-bound-mb", "1",
                       "--cache-ssd", f"aio:{tmp_path}/ssd",
                       "--cache-promote-depth", "1",
                       "--spool-queue-depth", "2",
                       "--host-mem-budget-mb", "1", "--metrics", metrics])
    out = capsys.readouterr().out
    assert "backend[managed]" in out and "aio: " in out
    with open(metrics) as f:
        row = json.loads(f.readline())
    assert row["cache_host_bound_bytes"] == 1 << 20
    assert "resilience_health" in row
    args = train.parse_args(base + ["--host-mem-budget-mb", "8"])
    assert train.io_config(args).host_mem_budget_bytes == 8 << 20
    # the jit engine's flags reach the config, and so does the meshes'
    # dedup switch; the jit flags on the staged engine, and a mesh on
    # the staged engine or larger than the world, are refused
    jit = base + ["--engine", "jit"]
    for flags, mode in ((["--host-offload"], "opt_state"),
                        (["--host-offload", "activations"], "activations"),
                        (["--opt-overlap", "--clip-norm", "0"], "none")):
        args = train.parse_args(jit + flags)
        assert train.io_config(args).host_offload == mode
    for flags in (["--spool-no-dedupe"], jit[len(base):] + [
            "--spool-no-dedupe"]):
        args = train.parse_args(base + flags)
        assert train.io_config(args).dedupe_replicas is False
    for bad in (["--host-offload", "opt_state"], ["--opt-overlap"],
                ["--mesh", "2x4"], ["--engine", "jit", "--mesh", "2x4"]):
        with pytest.raises(SystemExit):
            train.parse_args(base + bad)


class _HeldRead(tio.FilesystemBackend):
    """Reads complete, then wait for `gate` before returning."""

    def __init__(self, directory):
        super().__init__(directory)
        self.gate, self.read_done = (__import__("threading").Event()
                                     for _ in range(2))

    def _readinto(self, key, buf):
        n = super()._readinto(key, buf)
        self.read_done.set()
        self.gate.wait(10)
        return n


def test_a_dropped_records_late_load_never_feeds_the_next_record(tmp_path):
    """A prefetched load that completes after its record was dropped and
    a new record of the same key (the next step's) was stored must not
    hand its stale leaves to the new record."""
    be = _HeldRead(str(tmp_path))
    spool = TSpool(be, store_threads=1, load_threads=1,
                   min_offload_elements=0)
    try:
        old, new = torch.zeros(1000), torch.ones(1000)
        tx = spool.step("mb0")
        tx.offload(0, [old])
        spool.wait_io()
        tx.prefetch(0)
        assert be.read_done.wait(10)        # the old blob is read
        tx.close()                          # dropped while it loads
        tx = spool.step("mb0")
        tx.offload(0, [new])
        spool._store_q.join()               # the new blob landed
        be.gate.set()
        spool._load_q.join()
        assert torch.equal(tx.fetch(0)[0], new)
        tx.close()
    finally:
        be.gate.set()
        spool.close()


def test_the_pool_cap_reaches_an_aio_backends_own_pool(tmp_path):
    """An aio backend shares its pool with the spool; `pool_bytes` caps it
    whether the backend came from a kind or a spec string."""
    from repro_torch.core.spool import build_spool
    for backend in ("aio", f"aio:{tmp_path}/d@2"):
        spool = build_spool(TIo(backend=backend, directory=str(tmp_path),
                                pool_bytes=3 << 20))
        try:
            assert spool.pool is spool.backend.pool
            assert spool.pool.max_bytes == 3 << 20
        finally:
            spool.close()
