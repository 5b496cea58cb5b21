"""OFDM demodulation: sample stream -> equalized, frequency-deinterleaved
frame cell stream.

Batched structure (SURVEY.md §2.6/§7): all symbols of a frame are processed
as one batch — one batched FFT over (len_frame, fft_size), channel estimation
as gathers over precomputed pilot index tables + linear interpolation,
frequency deinterleaving as a single gather — replacing the reference's
per-carrier walk (`data_symbol.cpp:164-317`).

This module is NumPy; `rx.jaxdemod` provides the jitted device path with the
same semantics (these functions serve as its test oracle).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..dvbt2 import interleavers, tables
from ..dvbt2.params import T2Params


@functools.lru_cache(maxsize=None)
def pilot_tables(p: T2Params):
    """Precomputed per-symbol pilot/data index tables for one frame.

    Returns list over symbols of dicts with:
      pilot_pos (int32), pilot_ref (complex64: signed amplitude),
      data_pos (int32), rx_gather (int32 frequency-deinterleave map)
    """
    out = []
    p2_map = tables.p2_carrier_map(p)
    p2_refer = tables.p2_pilot_refer(p)
    _, _, rx_e, rx_o = interleavers.fi_gathers(p, "p2")
    p2_data = np.where(p2_map == tables.DATA)[0].astype(np.int32)
    for j in range(p.n_p2):
        ref = p2_refer[j]
        pos = np.where(ref != 0)[0].astype(np.int32)
        out.append(dict(pilot_pos=pos, pilot_ref=ref[pos],
                        data_pos=p2_data,
                        rx_gather=(rx_e if j % 2 == 0 else rx_o)))
    data_maps = tables.data_carrier_maps(p)
    data_refer = tables.data_pilot_refer(p)
    dy = data_maps.shape[0]
    _, _, rx_e, rx_o = interleavers.fi_gathers(p, "data")
    n_plain = p.n_data - (1 if p.has_fc else 0)
    for i in range(n_plain):
        l = p.n_p2 + i
        cmap = data_maps[l % dy]
        ref = data_refer[i]
        pos = np.where(ref != 0)[0].astype(np.int32)
        out.append(dict(pilot_pos=pos, pilot_ref=ref[pos],
                        data_pos=np.where(cmap == tables.DATA)[0].astype(np.int32),
                        rx_gather=(rx_e if l % 2 == 0 else rx_o)))
    if p.has_fc:
        l = p.len_frame - 1
        fc_map = tables.fc_carrier_map(p)
        ref = tables.fc_pilot_refer(p)
        pos = np.where(ref != 0)[0].astype(np.int32)
        _, _, rx_e, rx_o = interleavers.fi_gathers(p, "fc")
        out.append(dict(pilot_pos=pos, pilot_ref=ref[pos],
                        data_pos=np.where(fc_map == tables.DATA)[0].astype(np.int32),
                        rx_gather=(rx_e if l % 2 == 0 else rx_o)))
    return out


def extract_carriers(p: T2Params, x: np.ndarray, body_start: int) -> np.ndarray:
    """Strip GIs, batched FFT, gather the k_total active carriers.

    body_start: index of the first sample after the P1 (start of symbol 0's
    guard interval).  Returns (len_frame, k_total) complex64.
    """
    g, n = p.guard_size, p.fft_size
    sym = x[body_start:body_start + p.len_frame * p.symbol_size]
    sym = sym.reshape(p.len_frame, p.symbol_size)[:, g:]
    spec = np.fft.fftshift(np.fft.fft(sym, axis=1), axes=1)
    return spec[:, p.left_nulls:p.left_nulls + p.k_total]


@dataclass
class DemodResult:
    frame_cells: np.ndarray        # concatenated deinterleaved data cells
    snr_db: float                  # pilot-based SNR estimate
    timing_offset: float = 0.0     # symbol-timing offset in samples
    channel: np.ndarray | None = None


def _interp_complex(k: np.ndarray, pos: np.ndarray,
                    vals: np.ndarray) -> np.ndarray:
    return (np.interp(k, pos, vals.real)
            + 1j * np.interp(k, pos, vals.imag))


def _miso_eq_symbol(row: np.ndarray, t1: dict, t2: dict, k: np.ndarray):
    """One OFDM symbol of MISO combining; returns (deinterleaved cells,
    sum-channel pilot estimates, ref1) -- the latter two for SNR."""
    pos = t1["pilot_pos"]
    ref1 = t1["pilot_ref"]
    ref2 = t2["pilot_ref"]
    est = row[pos] / ref1                    # h1 +/- h2 per subset
    inverted = np.real(ref2 * np.conj(ref1)) < 0
    s_pos, s_est = pos[~inverted], est[~inverted]
    d_pos, d_est = pos[inverted], est[inverted]
    hsum = _interp_complex(k, s_pos, s_est)
    hdif = _interp_complex(k, d_pos, d_est)
    h1 = 0.5 * (hsum + hdif)
    h2 = 0.5 * (hsum - hdif)
    dpos = t1["data_pos"]
    r = row[dpos]
    h1p, h2p = h1[dpos], h2[dpos]
    r0, r1 = r[0::2], r[1::2]
    h1_0, h2_0 = h1p[0::2], h2p[0::2]
    h1_1, h2_1 = h1p[1::2], h2p[1::2]
    # [r0; r1*] = [[h1_0, -h2_0]; [h2_1*, h1_1*]] [e0; e1*]
    det = h1_0 * np.conj(h1_1) + h2_0 * np.conj(h2_1)
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    e0 = (np.conj(h1_1) * r0 + h2_0 * np.conj(r1)) / det
    e1 = np.conj((-np.conj(h2_1) * r0 + h1_0 * np.conj(r1)) / det)
    data = np.empty(len(dpos), dtype=np.complex64)
    data[0::2] = e0
    data[1::2] = e1
    return data[t1["rx_gather"]], s_est, ref1


def equalize_p2_symbol(p: T2Params, row: np.ndarray) -> np.ndarray:
    """Equalize + frequency-deinterleave the first P2 symbol only (the
    acquisition-phase L1-pre gate); MISO-aware."""
    k = np.arange(p.k_total)
    if p.miso:
        import dataclasses as _dc
        t1 = pilot_tables(_dc.replace(p, miso_group=0))[0]
        t2 = pilot_tables(_dc.replace(p, miso_group=1))[0]
        cells, _, _ = _miso_eq_symbol(row, t1, t2, k)
        return cells
    tabs = pilot_tables(p)[0]
    est_p = row[tabs["pilot_pos"]] / tabs["pilot_ref"]
    est = _interp_complex(k, tabs["pilot_pos"], est_p)
    eq = row / est
    return eq[tabs["data_pos"]][tabs["rx_gather"]]


def equalize_frame_miso(p: T2Params, carriers: np.ndarray) -> DemodResult:
    """MISO receive: dual channel estimation + Alamouti pair decode.

    Both transmitter groups send pilots at the same positions; group 2
    inverts the subset given by the clause-9.2 rule (dvbt2.tables
    `_miso_inverted`).  A received pilot is therefore ref*(h1+h2) on
    non-inverted positions and ref*(h1-h2) on the inverted subset.

    On DATA symbols the inversion parity (k/dx odd) equals the symbol's
    row parity, so per symbol one of the two subsets collapses to the few
    continual pilots — a per-symbol interpolation of that subset cannot
    follow a frequency-selective channel.  The sum and difference channels
    are therefore estimated FRAME-WIDE: every symbol's pilot estimates are
    pooled (duplicate carriers averaged), interpolated once across
    carriers, and each symbol then applies a per-symbol complex gain
    (least-squares fit of its own dense pilots against the pooled
    estimate) that re-absorbs common phase error.  Static-channel
    assumption across the frame — the terrestrial echo scenario; fast
    fading would need true 2D (time x frequency) interpolation.

    Data cells come in clause-9.1 Alamouti pairs
    r0 = h1*e0 - h2*e1*, r1 = h1*e1 + h2*e0* on adjacent data carriers;
    the exact 2x2 system is solved per pair (zero-forcing).  The
    reference receiver is SISO-only (README.md:17-23) — this exceeds it.
    """
    import dataclasses as _dc
    pg1 = _dc.replace(p, miso_group=0)
    pg2 = _dc.replace(p, miso_group=1)
    tabs1 = pilot_tables(pg1)
    tabs2 = pilot_tables(pg2)
    assert carriers.shape[0] == len(tabs1) == p.len_frame
    k = np.arange(p.k_total)

    # ---- pass 1: pool pilot estimates of both subsets across the frame --
    ests, invs = [], []
    s_pos, s_val, d_pos, d_val = [], [], [], []
    for row, t1, t2 in zip(carriers, tabs1, tabs2):
        pos, ref1, ref2 = t1["pilot_pos"], t1["pilot_ref"], t2["pilot_ref"]
        est = row[pos] / ref1
        inv = np.real(ref2 * np.conj(ref1)) < 0
        ests.append(est)
        invs.append(inv)
        s_pos.append(pos[~inv])
        s_val.append(est[~inv])
        d_pos.append(pos[inv])
        d_val.append(est[inv])

    def pooled(ps, vs):
        ps = np.concatenate(ps)
        vs = np.concatenate(vs)
        uk, idx = np.unique(ps, return_inverse=True)
        acc = np.bincount(idx, weights=np.real(vs)) \
            + 1j * np.bincount(idx, weights=np.imag(vs))
        avg = acc / np.bincount(idx)
        return uk, _interp_complex(k, uk, avg)

    sp_k, hsum = pooled(s_pos, s_val)
    dp_k, hdif = pooled(d_pos, d_val)
    h1 = 0.5 * (hsum + hdif)
    h2 = 0.5 * (hsum - hdif)

    # ---- pass 2: per-symbol complex gain + Alamouti pair solve ----------
    cells_out = []
    err_acc, sig_acc = 0.0, 0.0
    for row, t1, est, inv in zip(carriers, tabs1, ests, invs):
        pos = t1["pilot_pos"]
        href = np.where(inv, hdif[pos], hsum[pos])
        g = np.vdot(href, est) / max(float(np.vdot(href, href).real), 1e-30)
        dpos = t1["data_pos"]
        r = row[dpos]
        h1p, h2p = g * h1[dpos], g * h2[dpos]
        r0, r1 = r[0::2], r[1::2]
        h1_0, h2_0 = h1p[0::2], h2p[0::2]
        h1_1, h2_1 = h1p[1::2], h2p[1::2]
        det = h1_0 * np.conj(h1_1) + h2_0 * np.conj(h2_1)
        det = np.where(np.abs(det) < 1e-12, 1e-12, det)
        e0 = (np.conj(h1_1) * r0 + h2_0 * np.conj(r1)) / det
        e1 = np.conj((-np.conj(h2_1) * r0 + h1_0 * np.conj(r1)) / det)
        data = np.empty(len(dpos), dtype=np.complex64)
        data[0::2] = e0
        data[1::2] = e1
        cells_out.append(data[t1["rx_gather"]])
        # SNR from the residual of this symbol's pilots vs the fitted
        # pooled channel (noise + model mismatch)
        resid = est - g * href
        err_acc += float(np.mean(np.abs(resid) ** 2))
        sig_acc += float(np.mean(np.abs(est) ** 2))
    snr = 10.0 * np.log10(sig_acc / max(err_acc, 1e-30))
    return DemodResult(frame_cells=np.concatenate(cells_out), snr_db=snr,
                       timing_offset=0.0)


def equalize_frame(p: T2Params, carriers: np.ndarray) -> DemodResult:
    """Pilot-aided equalization + frequency deinterleave of one frame."""
    if p.miso:
        return equalize_frame_miso(p, carriers)
    tabs = pilot_tables(p)
    assert carriers.shape[0] == len(tabs) == p.len_frame
    k = np.arange(p.k_total)
    cells_out = []
    err_acc, sig_acc = 0.0, 0.0
    # symbol-timing offset from the pilot-phase slope of the first symbol:
    # a delay of tau samples rotates carrier k by -2*pi*k*tau/N (the quantity
    # the reference feeds its sample-rate loop, data_symbol.cpp:319-324)
    t0 = tabs[0]
    est0 = carriers[0][t0["pilot_pos"]] / t0["pilot_ref"]
    dphi = np.angle(np.sum(est0[1:] * np.conj(est0[:-1])))
    dk = float(np.mean(np.diff(t0["pilot_pos"])))
    timing = -dphi / (2.0 * np.pi * dk) * p.fft_size
    for row, tab in zip(carriers, tabs):
        pos = tab["pilot_pos"]
        ref = tab["pilot_ref"]
        est_p = row[pos] / ref
        # 3-tap [1,2,1]/4 pilot smoothing before interpolation: the same
        # estimator-noise cut the fused path applies (see
        # fusedpath._smooth_pilot_est; ~1 dB effective SNR at threshold).
        # The SNR estimate below stays on the RAW estimates — smoothed
        # differences would bias it high.
        est_s = (0.25 * np.concatenate([est_p[:1], est_p[:-1]])
                 + 0.5 * est_p
                 + 0.25 * np.concatenate([est_p[1:], est_p[-1:]]))
        # linear interpolation of the complex channel across carriers
        est = (np.interp(k, pos, est_s.real)
               + 1j * np.interp(k, pos, est_s.imag))
        eq = row / est
        data = eq[tab["data_pos"]]
        cells_out.append(data[tab["rx_gather"]])
        # SNR estimate from adjacent-pilot channel-estimate differences:
        # on a slowly-varying channel est_p[i]-est_p[i+1] is noise-dominated
        # (each pilot estimate carries noise/|ref|^2; the difference doubles
        # the noise variance), unlike the interpolated residual which is
        # zero at pilots by construction.
        d = est_p[1:] - est_p[:-1]
        err_acc += float(np.mean(np.abs(d) ** 2)) / 2.0 \
            * float(np.mean(np.abs(ref) ** 2))
        sig_acc += float(np.mean(np.abs(est_p) ** 2)) \
            * float(np.mean(np.abs(ref) ** 2))
    snr = 10.0 * np.log10(sig_acc / max(err_acc, 1e-30))
    return DemodResult(frame_cells=np.concatenate(cells_out), snr_db=snr,
                       timing_offset=float(timing))


def gi_fine_cfo(p: T2Params, x: np.ndarray, frame_start: int,
                fs: float, n_sym: int | None = None,
                p1_len: int = 2048) -> float:
    """Fine CFO (Hz) from guard-interval correlation averaged over the
    frame's OFDM symbols — the reference's per-symbol fine frequency
    loop (dvbt2_demodulator.cpp:321-330) in feed-forward form.

    The P1 preamble's fractional-CFO readout is only good to a few tens
    of Hz, which a 32K mode cannot tolerate (29 Hz residual = ~10% of
    the 279 Hz carrier spacing = ICI near -15 dB); the cyclic prefix
    gives an estimate unambiguous to +-fs/(2*fft) with ~Hz precision at
    threshold SNR (len_frame * guard_size products averaged).  Leading
    guard samples (the ISI-prone region under multipath) are skipped.
    """
    N, S, g = p.fft_size, p.symbol_size, p.guard_size
    k0 = frame_start + p1_len
    n_sym = n_sym if n_sym is not None else p.len_frame
    n_sym = min(n_sym, max(0, (len(x) - k0 - N - g) // S))
    if n_sym <= 0:
        return 0.0
    ks = np.arange(g // 4, g)
    idx = k0 + np.arange(n_sym)[:, None] * S + ks[None, :]
    a = x[idx]
    c = x[idx + N]
    z = np.sum(a * np.conj(c))
    return float(-np.angle(z) * fs / (2.0 * np.pi * N))
