"""Byte codecs of spooled blobs and their self-describing container, a
copy of the JAX package's `repro/io/codecs.py` (byte-level, so blobs are
interchangeable between the two packages).

Container: ``RIO1 | u8 name length | codec name | encoded payload``.
`raw` passes the payload through, `zlib` is stdlib DEFLATE level 1, and
`byteplane` splits 2-byte floats into low/high byte planes and DEFLATEs
only the (sign+exponent) high plane, in chunks encoded in parallel.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Type, Union

import numpy as np

_MAGIC = b"RIO1"


class Codec:
    #: registry key, set by @register_codec
    name: str = "?"

    def encode(self, data) -> bytes:
        raise NotImplementedError

    def decode(self, data):
        raise NotImplementedError


CODECS: Dict[str, Type[Codec]] = {}


def register_codec(name: str):
    def deco(cls: Type[Codec]) -> Type[Codec]:
        cls.name = name
        CODECS[name] = cls
        return cls
    return deco


def get_codec(codec: Union[str, Codec, None]) -> Codec:
    if codec is None:
        return RawCodec()
    if isinstance(codec, Codec):
        return codec
    try:
        return CODECS[codec]()
    except KeyError:
        raise KeyError(f"unknown codec {codec!r}; "
                       f"registered: {sorted(CODECS)}") from None


@register_codec("raw")
class RawCodec(Codec):
    def encode(self, data):
        return data

    def decode(self, data):
        return data


_LEVEL = 1                  # DEFLATE level of the zlib and byteplane codecs


@register_codec("zlib")
class ZlibCodec(Codec):
    def encode(self, data) -> bytes:
        return zlib.compress(data, _LEVEL)

    def decode(self, data) -> bytearray:
        return bytearray(zlib.decompress(data))


# one process-wide pool for byteplane chunks: zlib releases the GIL, so a
# blob's chunks compress in parallel, and the thread count stays bounded
_PLANE_EX: Optional[ThreadPoolExecutor] = None
_PLANE_EX_LOCK = threading.Lock()


def _plane_executor() -> ThreadPoolExecutor:
    global _PLANE_EX
    with _PLANE_EX_LOCK:
        if _PLANE_EX is None:
            _PLANE_EX = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="byteplane")
        return _PLANE_EX


@register_codec("byteplane")
class BytePlaneCodec(Codec):
    """Byte-plane shuffle + selective DEFLATE for 2-byte float payloads.

    Container: ``BPL1 | u8 level | u64 total | u32 nchunks`` then per
    chunk ``u8 flag | u32 clen | u32 hi_len`` + payload (flag 0: clen
    raw bytes; flag 1: ceil(clen/2) low-plane bytes + hi_len deflated
    high-plane bytes). Lossless for every dtype."""

    MAGIC = b"BPL1"
    CHUNK_BYTES = 1 << 20
    _HEAD = struct.Struct("<BQI")       # level, total bytes, nchunks
    _CHUNK = struct.Struct("<BII")      # flag, clen, hi_len

    @staticmethod
    def _encode_chunk(chunk: np.ndarray):
        lo = np.ascontiguousarray(chunk[0::2])
        hi = np.ascontiguousarray(chunk[1::2])
        comp = zlib.compress(hi, _LEVEL)
        if len(comp) >= hi.nbytes:
            return (0, chunk, b"")
        return (1, lo, comp)

    @staticmethod
    def _map(fn, jobs: List):
        if len(jobs) > 1:
            return list(_plane_executor().map(fn, jobs))
        return [fn(j) for j in jobs]

    def encode(self, data) -> bytes:
        arr = np.frombuffer(data, dtype=np.uint8)
        n = arr.nbytes
        chunks = [arr[o:o + self.CHUNK_BYTES]
                  for o in range(0, n, self.CHUNK_BYTES)] or [arr]
        encoded = self._map(self._encode_chunk, chunks)
        out: List = [self.MAGIC, self._HEAD.pack(_LEVEL, n, len(chunks))]
        for (flag, first, comp), chunk in zip(encoded, chunks):
            out.append(self._CHUNK.pack(flag, chunk.nbytes, len(comp)))
            out.append(first.data if isinstance(first, np.ndarray)
                       else first)
            if flag:
                out.append(comp)
        return b"".join(out)

    def decode(self, data) -> memoryview:
        mv = data if isinstance(data, memoryview) else memoryview(data)
        if mv.itemsize != 1 or mv.ndim != 1:
            mv = mv.cast("B")
        if bytes(mv[:4]) != self.MAGIC:
            raise ValueError("not a byteplane payload")
        _, total, nchunks = self._HEAD.unpack_from(mv, 4)
        out = np.empty(total, dtype=np.uint8)
        jobs = []
        off = 4 + self._HEAD.size
        start = 0
        for _ in range(nchunks):
            flag, clen, hi_len = self._CHUNK.unpack_from(mv, off)
            off += self._CHUNK.size
            first_len = clen if flag == 0 else clen - clen // 2
            jobs.append((flag, start, clen, mv[off:off + first_len],
                         mv[off + first_len:off + first_len + hi_len]))
            off += first_len + hi_len
            start += clen
        if start != total:
            raise ValueError("corrupt byteplane container")

        def dec(job):
            flag, start, clen, first, comp = job
            dst = out[start:start + clen]
            if flag == 0:
                dst[:] = np.frombuffer(first, dtype=np.uint8)
            else:
                dst[0::2] = np.frombuffer(first, dtype=np.uint8)
                dst[1::2] = np.frombuffer(zlib.decompress(comp),
                                          dtype=np.uint8)

        self._map(dec, jobs)
        return out.data


def encode_parts(parts, codec: Union[str, Codec, None] = None) -> List:
    """The container as a part list: header parts plus the encoded
    payload. The raw codec passes the payload parts through untouched;
    compressing codecs join once and contribute their output part."""
    c = get_codec(codec)
    name = c.name.encode("ascii")
    head: List = [_MAGIC, struct.pack("B", len(name)), name]
    if isinstance(c, RawCodec):
        return head + list(parts)
    return head + [c.encode(b"".join(
        p if isinstance(p, (bytes, bytearray, memoryview))
        else memoryview(p) for p in parts))]


def pack(payload, codec: Union[str, Codec, None] = None) -> bytes:
    """magic | u8 name length | codec name | encoded payload."""
    return b"".join(bytes(p) if isinstance(p, memoryview) else p
                    for p in encode_parts([payload], codec))


def unpack(blob):
    """Inverse of `pack`; blobs without the magic tag pass through."""
    if bytes(blob[:len(_MAGIC)]) != _MAGIC:
        return blob
    (nlen,) = struct.unpack_from("B", blob, len(_MAGIC))
    off = len(_MAGIC) + 1
    codec = get_codec(bytes(blob[off:off + nlen]).decode("ascii"))
    return codec.decode(memoryview(blob)[off + nlen:])
