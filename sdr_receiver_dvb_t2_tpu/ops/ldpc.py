"""Batched LDPC min-sum decoder in JAX (XLA device path).

A data-parallel redesign of the reference's 32-lane AVX2 layered decoder
(`LDPC/layered_decoder.hh`, `LDPC/avx2.hh`): a *flooding*-schedule offset
min-sum over a dense (R, deg_max) check-node adjacency, vectorized over an
arbitrary codeword batch.  Flooding removes the layer-serialization (the
reference compiles it as the alternative schedule, `ldpc_decoder.h:53-63`)
so every iteration is a handful of large gathers/reductions/scatter-adds
that XLA fuses into wide elementwise kernels, with thousands of codewords in flight instead
of 32.

Messages are kept in the requested dtype (float32 default; bfloat16 halves
HBM traffic at negligible BER cost for DVB-T2 operating points).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..dvbt2.ldpc import LDPCCode, get_code

_BIG = 1e30


@functools.lru_cache(maxsize=None)
def _decoder_cached(code_key, iters: int, offset: float, dtype_name: str):
    frame, rate = code_key
    code = get_code(frame, rate)
    return _build_decoder(code, iters, offset, jnp.dtype(dtype_name))


@functools.lru_cache(maxsize=None)
def _vn_adjacency(code_key) -> np.ndarray:
    """Variable-node edge lists: (N+1, vdeg_max) indices into the flat
    (R*dmax) edge space, padded with R*dmax (a zero slot).  Converts the
    per-iteration scatter-add into a gather + sum (gathers vectorise
    without write conflicts)."""
    frame, rate = code_key
    code = get_code(frame, rate)
    r, dmax = code.cn_idx.shape
    edges_of = [[] for _ in range(code.n + 1)]
    for e, bit in enumerate(code.cn_idx.reshape(-1)):
        edges_of[bit].append(e)
    vdeg = max(len(x) for x in edges_of[:code.n])
    out = np.full((code.n + 1, vdeg), r * dmax, dtype=np.int32)
    for nbit in range(code.n):
        out[nbit, :len(edges_of[nbit])] = edges_of[nbit]
    return out


def _build_decoder(code: LDPCCode, iters: int, offset: float, dtype):
    from ..dvbt2.params import CodeRate, FECFrame
    frame = FECFrame.NORMAL if code.n == 64800 else FECFrame.SHORT
    rate = CodeRate[code.name.split("_", 1)[1]]
    n = code.n
    idx = code.cn_idx.astype(np.int32)                       # (R, dmax)
    valid = code.cn_idx < code.n                             # (R, dmax)
    r, dmax = code.cn_idx.shape
    vn = _vn_adjacency((frame, rate))                        # (N+1, vdeg)

    def decode(llrs: jnp.ndarray) -> jnp.ndarray:
        """(B, N) float LLRs (positive = bit 0) -> (B, N) uint8 hard bits."""
        b = llrs.shape[0]
        llr_pad = jnp.concatenate(
            [llrs.astype(dtype), jnp.full((b, 1), _BIG, dtype)], axis=1)

        def body(carry, _):
            total, c2v = carry
            v2c = total[:, idx] - c2v                         # (B, R, dmax)
            v2c = jnp.where(valid, v2c, _BIG)
            mag = jnp.abs(v2c)
            neg = v2c < 0
            # leave-one-out sign: XOR of all signs in the row, minus own
            row_neg = jnp.sum(neg, axis=-1, keepdims=True) - neg
            loo_sign = jnp.where(row_neg % 2 == 1, -1.0, 1.0).astype(dtype)
            # two-minimum trick
            min1 = jnp.min(mag, axis=-1, keepdims=True)
            is_min1 = mag == min1
            # mask the first occurrence of the minimum only
            first_min = jnp.cumsum(is_min1, axis=-1) == 1
            first_min = jnp.logical_and(first_min, is_min1)
            mag2 = jnp.where(first_min, _BIG, mag)
            min2 = jnp.min(mag2, axis=-1, keepdims=True)
            loo_min = jnp.where(first_min, min2, min1)
            c2v_new = loo_sign * jnp.maximum(
                loo_min - jnp.asarray(offset, dtype), 0.0)
            c2v_new = jnp.where(valid, c2v_new, 0.0).astype(dtype)
            # variable-node update as a gather: edge messages per bit
            c2v_flat = jnp.concatenate(
                [c2v_new.reshape(b, -1), jnp.zeros((b, 1), dtype)], axis=1)
            total = llr_pad + jnp.sum(c2v_flat[:, vn], axis=-1)
            return (total, c2v_new), None

        init_c2v = jnp.zeros((b, r, dmax), dtype)
        (total, _), _ = jax.lax.scan(body, (llr_pad, init_c2v), None,
                                     length=iters)
        return (total[:, :n] < 0).astype(jnp.uint8)

    return jax.jit(decode)


def make_decoder(code: LDPCCode, iters: int = 25, offset: float = 0.5,
                 dtype: str = "float32"):
    """Jitted batched decoder for `code`: (B, N) llrs -> (B, N) hard bits."""
    from ..dvbt2.params import CodeRate, FECFrame
    # key by (frame, rate) via the code name for caching
    frame = FECFrame.NORMAL if code.n == 64800 else FECFrame.SHORT
    rate = CodeRate[code.name.split("_", 1)[1]]
    return _decoder_cached((frame, rate), iters, offset, dtype)


def syndrome_ok(code: LDPCCode, bits: np.ndarray) -> np.ndarray:
    """Batched syndrome check on host: (B, N) -> (B,) bool."""
    bits = np.asarray(bits, dtype=np.uint8)
    padded = np.concatenate(
        [bits, np.zeros((bits.shape[0], 1), np.uint8)], axis=1)
    return ~np.any(
        np.bitwise_xor.reduce(padded[:, code.cn_idx], axis=2) & 1, axis=1)
