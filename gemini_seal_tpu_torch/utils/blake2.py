"""BLAKE2b / BLAKE2xb (host side, numpy-vectorized).

Copy of gemini_seal_tpu.utils.blake2.

The reference derives all of its randomness and identifiers from BLAKE2
(reference: native/src/seal/util/blake2b.c, blake2xb.c, randomgen.cpp:63-74,
util/hash.h).  Two consumers:

- ``parms_id`` hashing: plain 32-byte blake2b of a u64 buffer (hash.h) —
  served by :func:`hash_uint64` via hashlib.
- ``BlakePRNG``: blake2xb(out=4096B, in=LE64(counter), key=seed[8]·u64) per
  refill.  blake2xb's output blocks use parameter-block fields (fanout=0,
  depth=0) that :mod:`hashlib` refuses, so the compression function is
  implemented here directly — vectorized over output blocks with numpy
  uint64 lanes, since all blocks of one XOF call compress the same message
  and differ only in their parameter words.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

__all__ = ["blake2b", "blake2xb", "hash_uint64", "Blake2xbPRNG"]

_IV = np.array(
    [
        0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
        0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
        0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
        0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
    ],
    dtype=np.uint64,
)

_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
)


def _rotr(x: np.ndarray, c: int) -> np.ndarray:
    c = np.uint64(c)
    return (x >> c) | (x << np.uint64(64 - c))


def _compress(h: np.ndarray, m: np.ndarray, t: int, last: bool) -> np.ndarray:
    """One blake2b compression, batched over the leading axis of ``h``.

    h: uint64[batch, 8] chaining values; m: uint64[16] (shared message block)
    or uint64[batch, 16]; t: byte offset counter; last: final-block flag.
    """
    batch = h.shape[0]
    v = np.empty((batch, 16), dtype=np.uint64)
    v[:, :8] = h
    v[:, 8:] = _IV
    v[:, 12] ^= np.uint64(t & 0xFFFFFFFFFFFFFFFF)
    v[:, 13] ^= np.uint64(t >> 64)
    if last:
        v[:, 14] ^= np.uint64(0xFFFFFFFFFFFFFFFF)
    if m.ndim == 1:
        m = np.broadcast_to(m, (batch, 16))

    def g(a, b, c, d, x, y):
        v[:, a] += v[:, b] + x
        v[:, d] = _rotr(v[:, d] ^ v[:, a], 32)
        v[:, c] += v[:, d]
        v[:, b] = _rotr(v[:, b] ^ v[:, c], 24)
        v[:, a] += v[:, b] + y
        v[:, d] = _rotr(v[:, d] ^ v[:, a], 16)
        v[:, c] += v[:, d]
        v[:, b] = _rotr(v[:, b] ^ v[:, c], 63)

    with np.errstate(over="ignore"):
        for s in _SIGMA:
            g(0, 4, 8, 12, m[:, s[0]], m[:, s[1]])
            g(1, 5, 9, 13, m[:, s[2]], m[:, s[3]])
            g(2, 6, 10, 14, m[:, s[4]], m[:, s[5]])
            g(3, 7, 11, 15, m[:, s[6]], m[:, s[7]])
            g(0, 5, 10, 15, m[:, s[8]], m[:, s[9]])
            g(1, 6, 11, 12, m[:, s[10]], m[:, s[11]])
            g(2, 7, 8, 13, m[:, s[12]], m[:, s[13]])
            g(3, 4, 9, 14, m[:, s[14]], m[:, s[15]])
    return h ^ v[:, :8] ^ v[:, 8:]


def blake2b(data: bytes, digest_size: int = 64, key: bytes = b"") -> bytes:
    """Plain sequential blake2b (delegates to hashlib)."""
    return hashlib.blake2b(data, digest_size=digest_size, key=key).digest()


def hash_uint64(words, out_words: int = 4):
    """HashFunction::hash (reference: util/hash.h): blake2b-256 over LE u64s."""
    buf = b"".join(struct.pack("<Q", w & 0xFFFFFFFFFFFFFFFF) for w in words)
    dig = hashlib.blake2b(buf, digest_size=out_words * 8).digest()
    return tuple(struct.unpack(f"<{out_words}Q", dig))


def _param_words(
    digest_length: int,
    key_length: int,
    fanout: int,
    depth: int,
    leaf_length: int,
    node_offset: int,
    xof_length: int,
    node_depth: int,
    inner_length: int,
) -> np.ndarray:
    """blake2b parameter block as 8 LE u64 words (salt/personal zero)."""
    blk = struct.pack(
        "<BBBBIIIBB14x16x16x",
        digest_length, key_length, fanout, depth,
        leaf_length, node_offset, xof_length, node_depth, inner_length,
    )
    return np.frombuffer(blk, dtype="<u8").astype(np.uint64)


def blake2xb(out_len: int, data: bytes, key: bytes = b"") -> bytes:
    """blake2xb XOF, bit-exact vs the reference (util/blake2xb.c:32-187).

    Root hash is a keyed sequential blake2b with xof_length planted in the
    parameter block; output block i re-hashes the root under node_offset=i
    with fanout=depth=0, leaf/inner = 64.
    """
    if not 0 < out_len <= 0xFFFFFFFF:
        raise ValueError("invalid blake2xb output length")
    if len(key) > 64:
        raise ValueError("key too long")

    # Root: parameter block has digest_length=64, key_length, fanout=1,
    # depth=1, xof_length=out_len.
    h = (_IV ^ _param_words(64, len(key), 1, 1, 0, 0, out_len, 0, 0))[None, :]
    msg = b""
    if key:
        msg += key + b"\x00" * (128 - len(key))
    msg += data
    # Sequential compression of msg (pad final block with zeros).
    n_blocks = max(1, (len(msg) + 127) // 128)
    for i in range(n_blocks):
        block = msg[i * 128 : (i + 1) * 128]
        is_last = i == n_blocks - 1
        t = len(msg) if is_last else (i + 1) * 128
        m = np.frombuffer(block.ljust(128, b"\x00"), dtype="<u8").astype(np.uint64)
        h = _compress(h, m, t, is_last)
    root = h[0].astype("<u8").tobytes()

    # Output blocks, batched: each is one compression of the padded root.
    n_out = (out_len + 63) // 64
    offsets = np.arange(n_out, dtype=np.uint64)
    digest_lengths = np.full(n_out, 64, dtype=np.uint64)
    if out_len % 64:
        digest_lengths[-1] = out_len % 64
    # Parameter word 0 = digest_length | key_length<<8 | fanout<<16 | depth<<24
    #                    | leaf_length<<32 ; fanout=depth=0, leaf_length=64.
    w0 = digest_lengths | (np.uint64(64) << np.uint64(32))
    # Word 1 = node_offset | xof_length<<32.
    w1 = offsets | (np.uint64(out_len) << np.uint64(32))
    # Word 2 = node_depth | inner_length<<8 ; node_depth=0, inner_length=64.
    w2 = np.uint64(64 << 8)
    h_out = np.broadcast_to(_IV, (n_out, 8)).copy()
    h_out[:, 0] ^= w0
    h_out[:, 1] ^= w1
    h_out[:, 2] ^= w2
    m = np.frombuffer(root.ljust(128, b"\x00"), dtype="<u8").astype(np.uint64)
    h_out = _compress(h_out, m, 64, True)
    return h_out.astype("<u8").tobytes()[:out_len]


class Blake2xbPRNG:
    """The reference's BlakePRNG stream (randomgen.h:199-220, .cpp:63-74).

    Emits the byte stream blake2xb(4096, LE64(counter), seed_bytes) for
    counter = 0, 1, 2, ... and serves typed reads off it.  The 31-/32-bit
    draw helpers mirror RandomToStandardAdapter (randomtostd.h) so sampler
    draw order can be replicated bit-exactly.
    """

    BUFFER_SIZE = 4096

    def __init__(self, seed):
        # seed: iterable of 8 uint64 (random_seed_type, randomgen.h:21)
        self.seed = tuple(int(s) & 0xFFFFFFFFFFFFFFFF for s in seed)
        if len(self.seed) != 8:
            raise ValueError("seed must have 8 uint64 words")
        self._seed_bytes = b"".join(struct.pack("<Q", s) for s in self.seed)
        self._counter = 0
        self._buffer = b""
        self._pos = 0
        self._pushback = bytearray()

    def _refill(self):
        from . import native

        if native.available():
            self._buffer = native.prng_fill(1, self.seed, self._counter)
        else:
            self._buffer = blake2xb(
                self.BUFFER_SIZE, struct.pack("<Q", self._counter), self._seed_bytes
            )
        self._counter += 1
        self._pos = 0

    def generate(self, byte_count: int) -> bytes:
        out = bytearray()
        if self._pushback:
            take = min(byte_count, len(self._pushback))
            out += self._pushback[:take]
            del self._pushback[:take]
            byte_count -= take
        while byte_count:
            if self._pos == len(self._buffer):
                self._refill()
            take = min(byte_count, len(self._buffer) - self._pos)
            out += self._buffer[self._pos : self._pos + take]
            self._pos += take
            byte_count -= take
        return bytes(out)

    def pushback(self, data: bytes):
        """Return unconsumed bytes to the front of the stream (used by
        vectorized samplers to keep exact draw-order parity after
        over-drawing a batch)."""
        self._pushback[:0] = data

    def draw_u32(self) -> int:
        return struct.unpack("<I", self.generate(4))[0]

    def draw_u32_array(self, count: int) -> np.ndarray:
        return np.frombuffer(self.generate(4 * count), dtype="<u4").astype(np.uint32)

    def draw_u64_array(self, count: int) -> np.ndarray:
        return np.frombuffer(self.generate(8 * count), dtype="<u8").astype(np.uint64)
