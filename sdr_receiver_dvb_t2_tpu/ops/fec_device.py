"""Device-side FEC tail: batched BCH parity check (a matmul over GF(2))
and BB descramble + byte packing, so decoded codewords become checkable
BB-frame bytes WITHOUT leaving the device.

The reference runs BCH (a stub — descramble only, bch_decoder.cpp:136-142)
and BB de-headering on dedicated CPU threads.  Here the per-codeword
syndrome gate and the descramble/pack are wide batched device ops; the host
only runs Berlekamp-Massey/Chien on the RARE dirty codeword (bch.decode)
and the byte-level TS reassembly (bbframe.TSAssembler) — kilobytes per
frame, not a bottleneck (SURVEY.md §7 "variable-rate TS reassembly").

GF(2) check: codeword c(x) is a BCH codeword iff g(x) | c(x), i.e. the
remainder of c(x) mod g(x) is zero.  remainder(x^d mod g) is a linear map,
so rem(c) = XOR over set bits of a precomputed (n_bch, parity) matrix —
that is one bf16 matmul with f32 accumulation followed by mod 2: the
operands are 0/1 and the sums stay below 2^24, so it is exact on any
device.
"""
from __future__ import annotations

import functools

import numpy as np

from ..dvbt2 import bbframe, bch
from ..dvbt2.params import CodeRate, FECFrame, PLPParams


@functools.lru_cache(maxsize=None)
def remainder_matrix(frame: FECFrame, n_bch: int, t: int) -> np.ndarray:
    """(n_bch, parity) uint8: row j = remainder of x^(n_bch-1-j) mod g(x).

    rem(codeword) = XOR of rows where the codeword bit is 1."""
    f = bch.field(frame, t)
    parity = f.parity
    mask = (1 << parity) - 1
    gen_low = f.gen_poly & mask
    out = np.empty((n_bch, parity), dtype=np.uint8)
    r = 1  # x^0
    for d in range(n_bch):
        j = n_bch - 1 - d
        for b in range(parity):
            out[j, b] = (r >> (parity - 1 - b)) & 1
        top = r & (1 << (parity - 1))
        r = (r << 1) & mask
        if top:
            r ^= gen_low
    return out


@functools.lru_cache(maxsize=None)
def make_bch_check_nb(frame: FECFrame, rate: CodeRate):
    """Jitted fn(bits (n_bch, B) uint8) -> ok (B,) bool.

    One bf16 matmul (f32 accumulation) + mod-2: the batched equivalent of the per-codeword
    `bch.syndromes` gate (all-zero remainder <=> all 2t syndromes zero)."""
    import jax
    import jax.numpy as jnp

    from ..dvbt2.params import fec_params
    fec = fec_params(frame, rate)
    rm = remainder_matrix(frame, fec.n_bch, fec.t_bch)
    rm_t = jnp.asarray(rm.T.astype(np.float32), dtype=jnp.bfloat16)

    def check(bits):
        b = bits.astype(jnp.bfloat16)
        synd = jax.lax.dot(rm_t, b, preferred_element_type=jnp.float32)
        odd = jax.lax.rem(synd.astype(jnp.int32), 2)
        return jnp.sum(odd, axis=0) == 0

    return jax.jit(check)


@functools.lru_cache(maxsize=None)
def _scramble_prbs(k_bch: int) -> np.ndarray:
    return bbframe.scramble(np.zeros((1, k_bch), np.uint8))[0]


@functools.lru_cache(maxsize=None)
def make_bb_bytes_nb(frame: FECFrame, rate: CodeRate):
    """Jitted fn(bits (>=k_bch, B) uint8) -> BB-frame bytes (k_bch//8, B)
    int32: descramble (XOR with the 0x4A80 PRBS, bb_de_header semantics)
    then pack each 8 bits into a byte on device."""
    import jax
    import jax.numpy as jnp

    from ..dvbt2.params import fec_params
    fec = fec_params(frame, rate)
    k = fec.k_bch
    prbs = _scramble_prbs(k).astype(np.int32)
    prbs_d = jnp.asarray(prbs.reshape(k // 8, 8))
    w = jnp.asarray((1 << np.arange(7, -1, -1)).astype(np.int32))

    def to_bytes(bits):
        b = bits[:k].astype(jnp.int32).reshape(k // 8, 8, -1)
        db = jnp.bitwise_xor(b, prbs_d[:, :, None])
        return jnp.sum(db * w[None, :, None], axis=1)

    return jax.jit(to_bytes)


def bch_correct_batch(plp: PLPParams, info_bits: np.ndarray,
                      stats) -> np.ndarray:
    """(B, n_bch) decoded bits -> (B, k_bch) corrected payload bits.

    Batched GEMM syndrome gate; full BM/Chien decode only on codewords the
    gate flags (clean-path cost: one matmul for the whole batch).  `stats`
    needs .bch_failures / .bch_corrected counters
    (rx.decode.PLPDecodeStats)."""
    fec = plp.fec
    ok = bch_check_host(plp, info_bits)
    bb = np.ascontiguousarray(info_bits[:, :fec.k_bch])
    for i in np.nonzero(~ok)[0]:
        fixed, nfix = bch.decode(plp.fec_frame, info_bits[i], fec.t_bch)
        if nfix < 0:
            stats.bch_failures += 1
        else:
            stats.bch_corrected += nfix
        bb[i] = fixed[:fec.k_bch]
    return bb


def bch_check_host(plp: PLPParams, bits: np.ndarray) -> np.ndarray:
    """Batched host-side BCH parity gate: (B, n_bch) bits -> (B,) bool ok.

    float32 GEMM against the remainder matrix — one call for the whole
    batch instead of the per-codeword Python `bch.syndromes` loop."""
    rm = remainder_matrix(plp.fec_frame, plp.fec.n_bch, plp.fec.t_bch)
    synd = np.asarray(bits, np.float32) @ rm.astype(np.float32)
    return ~((synd.astype(np.int64) & 1).any(axis=1))
