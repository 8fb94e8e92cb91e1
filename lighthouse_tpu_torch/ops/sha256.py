"""SHA-256 constants, digest layout helpers and a plain torch ``hash64``.

Port of ``lighthouse_tpu/ops/sha256.py``.  A 32-byte digest is 8
big-endian u32 words, held on the torch side as an ``(..., 8)`` int32
tensor of the same bit patterns (torch's ``uint32`` has no ``+``, ``<<``,
``>>`` or ``~``).  :func:`hash64` is the plain-PyTorch ``hash32_concat``:
it is the arithmetic the CUDA kernels of :mod:`.merkle_kernel` are held
to, and what their wrappers run for a tensor on the CPU.

Its words travel in int64 lanes masked to 32 bits: int32 ``>>`` sign-
extends and int32 ``+`` wraps, int64 does neither below 2^63.  A rotation
reads the word doubled into 64 bits, ``xx = x | x << 32``, so
``rotr(x, n) = (xx >> n) & 0xFFFFFFFF`` for every n < 32 (the bits kept
lie below bit 63 whatever the sign of ``xx``).
"""

from __future__ import annotations

import numpy as np
import torch

# Round constants (FIPS 180-4).
_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_IV = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)


def _schedule_np(block_words: np.ndarray) -> np.ndarray:
    """Host-side message schedule (python ints), for precomputing constants."""
    w = [int(x) for x in block_words]
    for i in range(16, 64):
        x15, x2 = w[i - 15], w[i - 2]
        s0 = ((x15 >> 7) | (x15 << 25)) ^ ((x15 >> 18) | (x15 << 14)) ^ (x15 >> 3)
        s1 = ((x2 >> 17) | (x2 << 15)) ^ ((x2 >> 19) | (x2 << 13)) ^ (x2 >> 10)
        w.append((w[i - 16] + (s0 & 0xFFFFFFFF) + w[i - 7] + (s1 & 0xFFFFFFFF)) & 0xFFFFFFFF)
    return np.array(w, dtype=np.uint32)


# Padding block for a 64-byte message: 0x80, zeros, then bit-length 512.
_PAD64_BLOCK = np.zeros(16, dtype=np.uint32)
_PAD64_BLOCK[0] = 0x80000000
_PAD64_BLOCK[15] = 512
# W+K folded together for the constant second block of hash64.
_PAD64_KW = ((_schedule_np(_PAD64_BLOCK).astype(np.uint64) + _K.astype(np.uint64))
             & 0xFFFFFFFF).astype(np.uint32)

_M32 = 0xFFFFFFFF
_K_INTS = [int(v) for v in _K]
_KW_INTS = [int(v) for v in _PAD64_KW]
_IV_INTS = [int(v) for v in _IV]


def _sigma(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """``rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3)`` of a masked word."""
    xx = x | (x << 32)
    return ((xx >> r1) ^ (xx >> r2) ^ (xx >> r3)) & _M32


def _small_sigma(x: torch.Tensor, r1: int, r2: int, s: int) -> torch.Tensor:
    """``rotr(x, r1) ^ rotr(x, r2) ^ (x >> s)`` of a masked word."""
    xx = x | (x << 32)
    return ((xx >> r1) ^ (xx >> r2)) & _M32 ^ (x >> s)


def _compress(state: list, kw) -> list:
    """64 rounds over masked int64 words.  ``kw(i)`` yields W[i] + K[i]
    (a tensor or a python int, unmasked)."""
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        t1 = h + _sigma(e, 6, 11, 25) + ((e & f) ^ (~e & g)) + kw(i)
        t2 = _sigma(a, 2, 13, 22) + ((a & b) ^ (a & c) ^ (b & c))
        h, g, f, e = g, f, e, (d + t1) & _M32
        d, c, b, a = c, b, a, (t1 + t2) & _M32
    return [(x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def hash64(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Batched ``hash32_concat``: SHA-256 of the 64-byte ``left || right``.

    ``left``/``right`` are ``(..., 8)`` int32 digests (u32 bit patterns)
    on any device; returns ``(..., 8)`` int32 on the same device.
    """
    shape = left.shape
    lw = left.reshape(-1, 8).to(torch.int64) & _M32
    rw = right.reshape(-1, 8).to(torch.int64) & _M32
    w = [lw[:, i] for i in range(8)] + [rw[:, i] for i in range(8)]

    def data_kw(i):
        if i >= 16:
            w[i % 16] = (w[i % 16] + _small_sigma(w[(i - 15) % 16], 7, 18, 3)
                         + w[(i - 7) % 16]
                         + _small_sigma(w[(i - 2) % 16], 17, 19, 10)) & _M32
        return w[i % 16] + _K_INTS[i]

    zero = torch.zeros_like(lw[:, 0])
    mid = _compress([zero + v for v in _IV_INTS], data_kw)
    out = _compress(mid, lambda i: _KW_INTS[i])
    words = torch.stack(out, dim=-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).reshape(shape)


# ---------------------------------------------------------------------------
# Host <-> device digest layout helpers
# ---------------------------------------------------------------------------

def bytes_to_words(data: bytes) -> np.ndarray:
    """Big-endian uint32 words from a byte string (len % 4 == 0)."""
    assert len(data) % 4 == 0
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)


def words_to_bytes(words: np.ndarray) -> bytes:
    """Inverse of :func:`bytes_to_words`."""
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()
