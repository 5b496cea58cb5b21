"""DVB-T2 interleaver address generators (frequency / cell / time / bit).

Every interleaver is expressed as a precomputed permutation array so that on
the device both directions are single gathers (SURVEY.md par.7 "tables as precomputed
arrays").  Conventions:

  * ``perm`` arrays are TX-side writes: ``interleaved[q] = plain[perm[q]]`` or
    as documented per function.  The inverse gather for RX is
    ``plain = interleaved[argsort/inv]`` and is returned where useful.

Parity with reference:
  - frequency interleaver LFSR + bit permutations, odd/even sequences and the
    32K one-sequence special case: address_freq_deinterleaver.cpp:28-209
  - cell (intra-FEC-block) interleaver LFSR with per-block bit-reversed shift:
    time_deinterleaver.cpp:174-266
  - time interleaver column/row structure + cyclic Q-delay:
    time_deinterleaver.cpp:288-376
  - bit interleaver column twist + demux orders: llr_demapper.cpp:110-130,
    llr_demapper.h:64-89
"""
from __future__ import annotations

import functools

import numpy as np

from . import _etsi_tables as ET
from .params import Constellation, FECFrame, T2Params

_FI_CONFIG = {
    # fft_size: (pn_degree, taps, even-permutation, odd-permutation)
    1024: (9, (0, 4), ET.FI_BITPERM_1KEVEN, ET.FI_BITPERM_1KODD),
    2048: (10, (0, 3), ET.FI_BITPERM_2KEVEN, ET.FI_BITPERM_2KODD),
    4096: (11, (0, 2), ET.FI_BITPERM_4KEVEN, ET.FI_BITPERM_4KODD),
    8192: (12, (0, 1, 4, 6), ET.FI_BITPERM_8KEVEN, ET.FI_BITPERM_8KODD),
    16384: (13, (0, 1, 4, 5, 9, 11), ET.FI_BITPERM_16KEVEN, ET.FI_BITPERM_16KODD),
    32768: (14, (0, 1, 2, 12), ET.FI_BITPERM_32K, ET.FI_BITPERM_32K),
}


@functools.lru_cache(maxsize=None)
def _fi_sequences(fft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Raw frequency-interleaver candidate addresses (even, odd) of length
    fft_size (clause 6.5.2): LFSR state, bit-permuted, + (i%2) * fft_size/2."""
    degree, taps, perm_even, perm_odd = _FI_CONFIG[fft_size]
    max_states = fft_size
    out_even = np.empty(max_states, dtype=np.int32)
    out_odd = np.empty(max_states, dtype=np.int32)
    lfsr = 0
    for i in range(max_states):
        if i in (0, 1):
            lfsr = 0
        elif i == 2:
            lfsr = 1
        else:
            fb = 0
            for t in taps:
                fb ^= (lfsr >> t) & 1
            lfsr >>= 1
            lfsr |= fb << (degree - 1)
        even = 0
        odd = 0
        for n in range(degree):
            bit = (lfsr >> n) & 1
            even |= bit << perm_even[n]
            odd |= bit << perm_odd[n]
        off = (i % 2) * (max_states // 2)
        out_even[i] = even + off
        out_odd[i] = odd + off
    return out_even, out_odd


def _fi_perms(fft_size: int, n_cells: int) -> tuple[np.ndarray, np.ndarray]:
    """TX frequency-interleaver permutations H_even, H_odd for a symbol with
    ``n_cells`` active cells: interleaved[q] = plain[H[q]].

    32K special case (one sequence): H_even := inverse(H_odd)
    (address_freq_deinterleaver.cpp:149-155).
    """
    seq_even, seq_odd = _fi_sequences(fft_size)
    h_even = seq_even[seq_even < n_cells].astype(np.int32)
    h_odd = seq_odd[seq_odd < n_cells].astype(np.int32)
    if fft_size == 32768:
        inv = np.empty_like(h_odd)
        inv[h_odd] = np.arange(len(h_odd), dtype=np.int32)
        h_even = inv
    return h_even, h_odd


@functools.lru_cache(maxsize=None)
def fi_tx(p: T2Params, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """(H_even, H_odd) TX permutations for 'p2' | 'data' | 'fc' symbols."""
    n = {"p2": p.c_p2, "data": p.c_data, "fc": p.n_fc}[kind]
    return _fi_perms(p.fft_size, n)


@functools.lru_cache(maxsize=None)
def fi_rx(p: T2Params, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """(inv_even, inv_odd) RX inverse maps: plain[q] = interleaved[inv[q]].

    NB the reference applies the *odd* inverse on even symbol indices and
    vice versa (p2_symbol.cpp:121, data_symbol.cpp:148); we expose maps by
    TX sequence and let the caller pick the parity convention.
    """
    h_even, h_odd = fi_tx(p, kind)
    inv_even = np.empty_like(h_even)
    inv_odd = np.empty_like(h_odd)
    inv_even[h_even] = np.arange(len(h_even), dtype=np.int32)
    inv_odd[h_odd] = np.arange(len(h_odd), dtype=np.int32)
    return inv_even, inv_odd


@functools.lru_cache(maxsize=None)
def fi_gathers(p: T2Params, kind: str) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray, np.ndarray]:
    """Frequency-interleaver gather maps by OFDM-symbol parity, matching the
    reference receiver's convention (even symbol index -> H_odd sequence,
    odd -> H_even: data_symbol.cpp:148-149, p2_symbol.cpp:121-122).

    Returns (tx_even, tx_odd, rx_even, rx_odd), all gathers:
        TX: interleaved = plain[tx_parity]
        RX: plain = interleaved[rx_parity]
    """
    h_even, h_odd = fi_tx(p, kind)
    inv_even, inv_odd = fi_rx(p, kind)
    return inv_odd, inv_even, h_odd, h_even


# ---------------------------------------------------------------------------
# Cell interleaver (clause 6.4): pseudo-random permutation within a FEC block,
# with a per-FEC-block bit-reversed shift.
# ---------------------------------------------------------------------------

_CI_CONFIG = {
    # pn_degree: (taps, mask)
    11: ((0, 3), 0x3FF),
    12: ((0, 2), 0x7FF),
    13: ((0, 1, 4, 6), 0xFFF),
    14: ((0, 1, 4, 5, 9, 11), 0x1FFF),
    15: ((0, 1, 2, 12), 0x3FFF),
}


@functools.lru_cache(maxsize=None)
def _ci_base_permutation(cells: int) -> np.ndarray:
    """Base cell-interleaver sequence L_r(q) for shift 0, length ``cells``."""
    degree = int(np.ceil(np.log2(cells)))
    taps, mask = _CI_CONFIG[degree]
    max_states = 1 << degree
    out = np.empty(cells, dtype=np.int32)
    lfsr = 0
    q = 0
    for i in range(max_states):
        if i in (0, 1):
            lfsr = 0
        elif i == 2:
            lfsr = 1
        else:
            fb = 0
            for t in taps:
                fb ^= (lfsr >> t) & 1
            lfsr &= mask
            lfsr >>= 1
            lfsr |= fb << (degree - 2)
        val = lfsr | ((i % 2) << (degree - 1))
        if val < cells:
            out[q] = val
            q += 1
    assert q == cells
    return out


@functools.lru_cache(maxsize=None)
def cell_interleaver_shifts(cells: int, num_blocks: int) -> np.ndarray:
    """Per-FEC-block shifts: bit-reversal of successive counters, rejecting
    values >= cells (time_deinterleaver.cpp:248-259)."""
    degree = int(np.ceil(np.log2(cells)))
    shifts = np.empty(num_blocks, dtype=np.int32)
    n = 0
    for r in range(num_blocks):
        shift = cells
        while shift >= cells:
            temp = n
            shift = 0
            for _ in range(degree):
                shift |= temp & 1
                shift <<= 1
                temp >>= 1
            n += 1
        shifts[r] = shift
    return shifts


@functools.lru_cache(maxsize=None)
def cell_interleaver_perm(cells: int, num_blocks: int) -> np.ndarray:
    """TX cell-interleaver permutation per FEC block, shape (num_blocks, cells).

    TX: interleaved[r, L[r, w]] = plain[r, w]  i.e. writing address L.
    RX deinterleave is the gather plain[r, w] = interleaved[r, L[r, w]].
    """
    base = _ci_base_permutation(cells)
    shifts = cell_interleaver_shifts(cells, num_blocks)
    return (base[None, :] + shifts[:, None]) % cells


# ---------------------------------------------------------------------------
# Time interleaver (clause 6.5): column-row block interleaver over a TI block
# of n_fec FEC blocks, n_split=5 columns each, rows = cells/5.
# ---------------------------------------------------------------------------

def time_interleaver_perm(cells_per_fec: int, n_fec: int) -> np.ndarray:
    """TX time-interleaver read order for one TI block.

    The TI block is a (rows x cols) array written column-by-column with the
    (cell-interleaved) FEC blocks, cols = 5 * n_fec, rows = cells_per_fec / 5,
    then read row-by-row onto OFDM cells.  Returns ``order`` such that
    tx_cells[i] = ti_input[order[i]] where ti_input is the concatenation of
    the n_fec cell-interleaved FEC blocks.

    The reference RX reconstructs this implicitly by scattering each received
    cell to ``cell_deint[idx_step + idx_row]`` (time_deinterleaver.cpp:316-334).
    """
    n_split = 5
    rows = cells_per_fec // n_split
    cols = n_split * n_fec
    idx = np.arange(rows * cols, dtype=np.int64)
    r, c = idx // cols, idx % cols
    return (c * rows + r).astype(np.int32)


def q_delay_tx(cells: np.ndarray, cells_per_fec: int) -> np.ndarray:
    """Apply the rotated-constellation cyclic Q-delay (clause 6.3.2): within
    each FEC block, the imaginary part is delayed cyclically by one cell.

    cells: complex array (..., n_fec * cells_per_fec) laid out FEC block by
    FEC block (after cell-word mapping, before cell interleaving).
    """
    shape = cells.shape[:-1] + (-1, cells_per_fec)
    blk = cells.reshape(shape)
    q = np.roll(blk.imag, 1, axis=-1)
    return (blk.real + 1j * q).reshape(cells.shape).astype(cells.dtype)


def q_delay_rx_indices(cells_per_fec: int, n_fec: int) -> tuple[np.ndarray, np.ndarray]:
    """Gather indices undoing the cyclic Q-delay over a TI block:
    out[i] = re[i] + 1j * im[qidx[i]] with qidx = (i+1) mod within-block."""
    idx = np.arange(n_fec * cells_per_fec, dtype=np.int64)
    blk = idx // cells_per_fec
    off = idx % cells_per_fec
    qidx = blk * cells_per_fec + (off + 1) % cells_per_fec
    return idx.astype(np.int32), qidx.astype(np.int32)


# ---------------------------------------------------------------------------
# Bit interleaver (clause 6.2.1): parity interleaver + column-twist + demux.
# ---------------------------------------------------------------------------

_TWIST = {
    # (constellation, frame): (columns parameter list 'tc', n_cols)
    (Constellation.QAM16, FECFrame.SHORT): ([0, 0, 0, 1, 7, 20, 20, 21], 8),
    (Constellation.QAM16, FECFrame.NORMAL): ([0, 0, 2, 4, 4, 5, 7, 7], 8),
    (Constellation.QAM64, FECFrame.SHORT): ([0, 0, 0, 2, 2, 2, 3, 3, 3, 6, 7, 7], 12),
    (Constellation.QAM64, FECFrame.NORMAL): ([0, 0, 2, 2, 3, 4, 4, 5, 5, 7, 8, 9], 12),
    (Constellation.QAM256, FECFrame.SHORT): ([0, 0, 0, 1, 7, 20, 20, 21], 8),
    (Constellation.QAM256, FECFrame.NORMAL): (
        [0, 2, 2, 2, 2, 3, 7, 15, 16, 20, 22, 22, 27, 27, 28, 32], 16),
}


def _demux_order(c: Constellation, frame: FECFrame, rate) -> list[int] | None:
    """Bit-to-cell-word demux order (clause 6.2.1 tables); None => identity."""
    from .params import CodeRate
    if c == Constellation.QPSK:
        return None
    if c == Constellation.QAM16:
        if frame == FECFrame.NORMAL and rate == CodeRate.C3_5:
            return [0, 2, 3, 6, 4, 1, 7, 5]
        return list(ET.BIT_DEMUX_16)
    if c == Constellation.QAM64:
        if frame == FECFrame.NORMAL and rate == CodeRate.C3_5:
            return [4, 6, 0, 5, 8, 10, 2, 1, 7, 3, 11, 9]
        return list(ET.BIT_DEMUX_64)
    if c == Constellation.QAM256:
        from .params import CodeRate
        if frame == FECFrame.SHORT:
            return [7, 2, 4, 1, 6, 3, 5, 0]
        if rate == CodeRate.C3_5:
            return [4, 6, 0, 2, 3, 14, 12, 10, 7, 5, 8, 1, 15, 9, 11, 13]
        if rate == CodeRate.C2_3:
            return [3, 15, 1, 7, 4, 11, 5, 0, 12, 2, 9, 14, 13, 6, 8, 10]
        return [15, 1, 13, 3, 10, 7, 9, 11, 4, 6, 8, 5, 12, 2, 14, 0]
    raise ValueError(c)


@functools.lru_cache(maxsize=None)
def parity_interleaver_perm(n_ldpc: int, k_ldpc: int, q_ldpc: int) -> np.ndarray:
    """Parity interleaver (clause 6.2.1 eq. 6.1): permutation over the whole
    FEC frame; data part identity, parity part u[k + 360t + s] = c[k + q s + t].

    Returns perm with interleaved[i] = plain[perm[i]].
    """
    perm = np.arange(n_ldpc, dtype=np.int32)
    r = n_ldpc - k_ldpc
    t = np.arange(q_ldpc)[:, None]
    s = np.arange(360)[None, :]
    # position k + 360t + s takes plain parity index q*s + t
    perm[k_ldpc:] = (k_ldpc + (q_ldpc * s + t).reshape(-1)).astype(np.int32)
    assert perm.shape[0] == n_ldpc and r == 360 * q_ldpc
    return perm


@functools.lru_cache(maxsize=None)
def bit_interleaver_perm(c: Constellation, frame: FECFrame, rate) -> np.ndarray:
    """Combined column-twist interleave + demux permutation for one FEC frame.

    Returns ``addr`` of length n_ldpc such that the w-th bit feeding the
    cell-word stream (v-stream order: cell ceil(w/m), bit w%m within the
    demuxed word) comes from twist-interleaver *input* position addr[w]:

        v[w] = u[addr[w]]      (TX, u = parity-interleaved codeword)
        llr_u[addr[w]] = llr_v[w]   (RX scatter, as the reference does:
                                     llr_demapper.cpp:110-130)

    For QPSK there is no twist/demux: addr = identity.
    """
    from .params import fec_params
    fec = fec_params(frame, rate)
    n = fec.n_ldpc
    m = c.bits_per_cell
    if c == Constellation.QPSK:
        return np.arange(n, dtype=np.int32)
    tc, n_cols = _TWIST[(c, frame)]
    n_rows = n // n_cols
    # column-twist: bit at (col r, row c_) of the interleaver was written from
    # serial input; reference: address[c*row_ + r] = column*r + (c + column - tc[r]) % column
    # where 'column' = n_rows (their naming is transposed); replicate exactly:
    col = n_rows
    row = n_cols
    cgrid = np.arange(col)[:, None]
    rgrid = np.arange(row)[None, :]
    address = col * rgrid + (cgrid + col - np.array(tc)[None, :]) % col
    address = address.reshape(-1)  # index: c * row + r
    demux = np.array(_demux_order(c, frame, rate), dtype=np.int64)
    w = np.arange(n, dtype=np.int64)
    k = (w // row) * row
    addr = address[demux[w % row] + k]
    return addr.astype(np.int32)
