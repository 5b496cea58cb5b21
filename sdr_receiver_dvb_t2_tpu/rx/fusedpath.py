"""Fused device receive path: frame samples -> codeword LLRs in (N, B) layout.

Second-generation device pipeline built from profiling the v1 path
(rx/jaxdemod.py), whose element-granular gathers of channel estimation
dominated it: every gather here is restructured to fetch whole rows of a
carrier-major (k_total, n_sym) layout, and the irregular linear
interpolation indexes rows with precomputed stencils:

  - symbols grouped into CLASSES with identical tables (P2 by parity, data
    symbols by l mod dy -- dy is even so the frequency-interleaver parity is
    a function of the class -- FC);
  - pilot extraction   = row gather of pilot_pos rows (x class columns)
  - interpolation      = two row gathers of the pilot-estimate rows + FMA
    (the irregular linear-interp stencil indexes ROWS, so it is DMA-friendly;
    a dense weight-matrix matmul also works but bakes ~GB constants)
  - data + frequency deinterleave = ONE composed row gather per class
  - PLP time/cell deinterleave    = one composed gather (TI o layout)
  - LLRs computed separably per axis, emitted TRANSPOSED (n_ldpc, B) so the
    bit deinterleaver is a row gather and the QC-layered LDPC layout needs
    no batch transpose at all.

Layout rule: float32 (or bf16) re/im planes, not complex arrays.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..dvbt2 import interleavers, l1 as l1mod, tables
from ..dvbt2.params import PLPParams, T2Params
from . import demod as npdemod
from .jaxdemod import _interp_stencil


class _Class:
    def __init__(self, sym_cols, pilot_rows, inv_ref, stencil, comp_rows,
                 miso=None):
        self.sym_cols = sym_cols        # (nc,) symbol indices
        self.pilot_rows = pilot_rows    # (np_c,)
        self.inv_ref = inv_ref          # (np_c, nc) float32, 1/ref
        self.stencil = stencil          # (il, ir, w): row indices + weight
        self.comp_rows = comp_rows      # (n_data_c,) data+FI composed rows
        self.miso = miso                # dict, see FusedFrameDemod.__init__
        # comp-first variant: the interp stencil REMAPPED to composed data
        # rows, so the channel is only ever computed where it is consumed
        # and the equalizer writes directly in composed order (no full-k
        # intermediate, no trailing comp gather)
        il, ir, w = stencil
        wf = np.asarray(w).reshape(-1)
        self.comp_stencil = (il[comp_rows], ir[comp_rows],
                             wf[comp_rows].reshape(-1, 1))
        self.pilot_rows_wrapped = None  # set when the demod folds fftshift
        self.comp_rows_wrapped = None
        # classes are arithmetic progressions of symbol indices by
        # construction (P2 parity / l mod dy / FC) -> expressible as a
        # strided slice, which is much cheaper than a middle-axis gather
        self.start = int(sym_cols[0])
        self.step = int(sym_cols[1] - sym_cols[0]) if len(sym_cols) > 1 else 1
        self.count = len(sym_cols)
        assert np.array_equal(
            np.asarray(sym_cols),
            self.start + self.step * np.arange(self.count))


def class_pilot_est(c: _Class, xcr, xci, rep: int):
    """Pilot channel estimates of one class: (epr, epi) of (np_c, nc*rep)."""
    iref = jnp.asarray(
        np.repeat(c.inv_ref, rep, axis=1) if rep > 1 else c.inv_ref,
        dtype=xcr.dtype)
    return xcr[c.pilot_rows] * iref, xci[c.pilot_rows] * iref


def _eq_class_planar(c: _Class, xcr, xci, rep: int, ests=None):
    """Equalize + frequency-deinterleave one symbol class, planar f32.

    xcr/xci: (k_total, nc*rep) carrier-major rows (rep = frames folded into
    the lane axis).  Returns (out_r, out_i) of (n_data_c, nc*rep) rows in
    frequency-deinterleaved (plain-cell) order.

    SISO: pilot row-gather -> two-gather linear interpolation -> one-tap
    equalize -> composed data+FI row gather.
    MISO: the received pilots carry ref*(h1+h2) on non-inverted positions
    and ref*(h1-h2) on the TX2-inverted subset (clause 9.2 inversions).
    On DATA symbols the inversion parity equals the symbol's row parity,
    so one subset per class collapses to the continual pilots; that
    channel is taken from the PARTNER class (symbols one row away, where
    the subset is dense), lane-aligned to the nearest partner symbol —
    static-channel assumption over adjacent symbols, same as
    rx.demod.equalize_frame_miso's frame pooling.  `ests` is the list of
    all classes' pilot estimates (class_pilot_est).  Adjacent data
    carriers form clause-9.1 Alamouti pairs solved exactly as a 2x2
    system (zero-forcing) — exceeds the SISO-only reference
    (README.md:17-23)."""
    dt = xcr.dtype

    def cst(a):
        # numpy constants are strongly typed f32 and would promote the
        # whole chain; pin them to the compute dtype (bf16 demod halves
        # the HBM traffic of every elementwise stage here)
        return jnp.asarray(a, dtype=dt)

    if c.miso is None:
        epr, epi = class_pilot_est(c, xcr, xci, rep)
        epr, epi = _smooth_pilot_est(epr, epi)
        il, ir, w = c.stencil               # w: (k, 1)
        w = cst(w)
        chr_ = epr[il] * (1.0 - w) + epr[ir] * w
        chi_ = epi[il] * (1.0 - w) + epi[ir] * w
        inv = 1.0 / (chr_ * chr_ + chi_ * chi_)
        eqr = (xcr * chr_ + xci * chi_) * inv
        eqi = (xci * chr_ - xcr * chi_) * inv
        return eqr[c.comp_rows], eqi[c.comp_rows]
    mi = c.miso
    own = ests[mi["self_idx"]] if ests is not None \
        else class_pilot_est(c, xcr, xci, rep)

    def subset_channel(sub):
        if sub["src_idx"] is None:
            sr_, si_ = own
        else:
            sr_, si_ = ests[sub["src_idx"]]
        sr_, si_ = sr_[sub["sel"]], si_[sub["sel"]]
        lm = sub["lane_map"]
        if lm is not None:
            # align partner symbols to this class's lanes (nearest row)
            nc_src = sub["nc_src"]
            sr_ = sr_.reshape(sr_.shape[0], nc_src, rep
                              )[:, lm, :].reshape(sr_.shape[0], -1)
            si_ = si_.reshape(si_.shape[0], nc_src, rep
                              )[:, lm, :].reshape(si_.shape[0], -1)
        il, ir, w = sub["stencil"]
        w = cst(w)
        return (sr_[il] * (1.0 - w) + sr_[ir] * w,
                si_[il] * (1.0 - w) + si_[ir] * w)

    hs_r, hs_i = subset_channel(mi["sum"])
    hd_r, hd_i = subset_channel(mi["dif"])
    h1r, h1i = 0.5 * (hs_r + hd_r), 0.5 * (hs_i + hd_i)
    h2r, h2i = 0.5 * (hs_r - hd_r), 0.5 * (hs_i - hd_i)
    dp = mi["data_rows"]
    r_r, r_i = xcr[dp], xci[dp]             # (n_data_c, lanes)
    h1r_d, h1i_d = h1r[dp], h1i[dp]
    h2r_d, h2i_d = h2r[dp], h2i[dp]
    # Alamouti pairs on adjacent data carriers:
    #   r0 = h1_0 e0 - h2_0 e1*,   r1 = h1_1 e1 + h2_1 e0*
    r0r, r0i = r_r[0::2], r_i[0::2]
    r1r, r1i = r_r[1::2], r_i[1::2]
    a_r, a_i = h1r_d[0::2], h1i_d[0::2]     # h1_0
    b_r, b_i = h2r_d[0::2], h2i_d[0::2]     # h2_0
    c_r, c_i = h1r_d[1::2], h1i_d[1::2]     # h1_1
    d_r, d_i = h2r_d[1::2], h2i_d[1::2]     # h2_1

    def cmul(ar, ai, br, bi):
        return ar * br - ai * bi, ar * bi + ai * br

    # det = h1_0 * conj(h1_1) + h2_0 * conj(h2_1)
    t0r, t0i = cmul(a_r, a_i, c_r, -c_i)
    t1r, t1i = cmul(b_r, b_i, d_r, -d_i)
    det_r, det_i = t0r + t1r, t0i + t1i
    inv_d2 = 1.0 / jnp.maximum(det_r * det_r + det_i * det_i, 1e-24)
    # e0 = (conj(h1_1) * r0 + h2_0 * conj(r1)) / det
    n0r, n0i = cmul(c_r, -c_i, r0r, r0i)
    m0r, m0i = cmul(b_r, b_i, r1r, -r1i)
    n0r, n0i = n0r + m0r, n0i + m0i
    e0r, e0i = cmul(n0r, n0i, det_r * inv_d2, -det_i * inv_d2)
    # e1 = conj((-conj(h2_1) * r0 + h1_0 * conj(r1)) / det)
    n1r, n1i = cmul(-d_r, d_i, r0r, r0i)
    m1r, m1i = cmul(a_r, a_i, r1r, -r1i)
    n1r, n1i = n1r + m1r, n1i + m1i
    e1r, e1i = cmul(n1r, n1i, det_r * inv_d2, -det_i * inv_d2)
    e1i = -e1i
    # emitted in sorted carrier order; the frequency deinterleave is
    # folded into demod.layout (rides the downstream cell gather)
    out_r = jnp.stack([e0r, e1r], axis=1).reshape(r_r.shape)
    out_i = jnp.stack([e0i, e1i], axis=1).reshape(r_i.shape)
    return out_r, out_i


def _smooth_pilot_est(epr, epi):
    """3-tap [1,2,1]/4 smoothing of the pilot channel estimates along the
    pilot axis (edge-replicated).

    The scattered pilots' 7/3 power boost gives the raw estimate
    ~SNR+3.7 dB; linear interpolation passes that noise straight into
    the one-tap equalizer (~1 dB effective SNR loss at threshold).  The
    smoother cuts estimator noise ~4.3 dB while keeping the echo
    tolerance of the pilot lattice — real receivers run 2D Wiener
    filters here; the reference interpolates raw pilots
    (p2_symbol.cpp:142-192).  Measured at the 32K bench's 19 dB point:
    LDPC 13.6 -> fewer iters/frame; multipath e2e suites stay green."""
    def sm(e):
        top = jnp.concatenate([e[:1], e[:-1]], axis=0)
        bot = jnp.concatenate([e[1:], e[-1:]], axis=0)
        return 0.25 * top + 0.5 * e + 0.25 * bot
    return sm(epr), sm(epi)


def _eq_class_comp(c: _Class, xcr, xci, rep: int, wrapped: bool = False):
    """Comp-first SISO equalize: the channel is interpolated ONLY at the
    composed data rows (comp_stencil) and the one-tap equalizer writes
    directly in composed (frequency-deinterleaved) order — no full-k
    intermediate, no trailing comp gather.  With wrapped=True the row
    tables carry the fftshift offset, so xcr/xci are the RAW (fft, lanes)
    carrier-major FFT output and the to_carriers concat pass disappears.
    Element-for-element the same arithmetic as `_eq_class_planar`
    followed by the comp gather (bit-identical outputs)."""
    dt = xcr.dtype
    prow = c.pilot_rows_wrapped if wrapped else c.pilot_rows
    drow = c.comp_rows_wrapped if wrapped else c.comp_rows
    iref = jnp.asarray(
        np.repeat(c.inv_ref, rep, axis=1) if rep > 1 else c.inv_ref,
        dtype=dt)
    epr = xcr[prow] * iref
    epi = xci[prow] * iref
    epr, epi = _smooth_pilot_est(epr, epi)
    il, ir, w = c.comp_stencil
    w = jnp.asarray(w, dtype=dt)
    chr_ = epr[il] * (1.0 - w) + epr[ir] * w
    chi_ = epi[il] * (1.0 - w) + epi[ir] * w
    xdr = xcr[drow]
    xdi = xci[drow]
    inv = 1.0 / (chr_ * chr_ + chi_ * chi_)
    eqr = (xdr * chr_ + xdi * chi_) * inv
    eqi = (xdi * chr_ - xdr * chi_) * inv
    return eqr, eqi


class FusedFrameDemod:
    """Carrier-major demod: (len_frame*symbol_size, 2) -> per-class data-cell
    blocks plus the host-side `layout` map (frame cell index -> flat
    class-output position)."""

    def __init__(self, p: T2Params):
        self.p = p
        if p.miso:
            import dataclasses as _dc
            tabs = npdemod.pilot_tables(_dc.replace(p, miso_group=0))
            tabs2 = npdemod.pilot_tables(_dc.replace(p, miso_group=1))
        else:
            tabs = npdemod.pilot_tables(p)
            tabs2 = None
        n_plain = p.n_data - (1 if p.has_fc else 0)
        dy = tables.SP_PATTERN[p.pilot_pattern][1]
        # build classes: P2 split by parity, data by l%dy, FC alone
        class_rows: list[list[int]] = []
        p2_even = [j for j in range(p.n_p2) if j % 2 == 0]
        p2_odd = [j for j in range(p.n_p2) if j % 2 == 1]
        for rows in (p2_even, p2_odd):
            if rows:
                class_rows.append(rows)
        for c in range(dy):
            rows = [p.n_p2 + i for i in range(n_plain)
                    if (p.n_p2 + i) % dy == c]
            if rows:
                class_rows.append(rows)
        if p.has_fc:
            class_rows.append([p.len_frame - 1])
        self.classes = []
        # layout[f] = flat position of frame cell f in the concatenated
        # class outputs (row-major (n_data_c, nc) per class)
        cells_per_sym = [len(tabs[r]["data_pos"]) for r in range(p.len_frame)]
        sym_cell_off = np.concatenate([[0], np.cumsum(cells_per_sym)])
        total = int(sym_cell_off[-1])
        layout = np.empty(total, dtype=np.int64)
        flat_off = 0
        for rows in class_rows:
            t0 = tabs[rows[0]]
            pilot_rows = t0["pilot_pos"]
            n_data_c = len(t0["data_pos"])
            nc = len(rows)
            inv_ref = np.stack(
                [1.0 / np.real(tabs[r]["pilot_ref"]).astype(np.float32)
                 for r in rows], axis=1)
            il, ir, w = _interp_stencil(pilot_rows, p.k_total)
            stencil = (il, ir, w.reshape(-1, 1))
            # data rows in SORTED carrier order: the frequency
            # deinterleave (rx_gather) is FOLDED INTO `layout` below, so
            # it rides the downstream composed cell gather for free and
            # every EQ-side gather keeps MONOTONE indices (a
            # pseudorandom-index gather is measurably slower per row)
            comp = t0["data_pos"]
            rxg = t0["rx_gather"]
            miso = None
            if p.miso:
                # TX2 pilot-inversion subset is a function of the carrier
                # map alone, identical for every symbol of a class (the
                # clause-9.2 rule depends on k and l%dy only)
                ref2 = tabs2[rows[0]]["pilot_ref"]
                inverted = np.real(ref2 * np.conj(t0["pilot_ref"])) < 0
                for r in rows[1:]:
                    inv_r = np.real(tabs2[r]["pilot_ref"]
                                    * np.conj(tabs[r]["pilot_ref"])) < 0
                    assert np.array_equal(inv_r, inverted)
                assert n_data_c % 2 == 0, "Alamouti pairs need even cells"
                miso = dict(
                    inverted=inverted,
                    data_rows=t0["data_pos"].astype(np.int32))
            for ci, r in enumerate(rows):
                # frame cell (sym r, plain cell i) = carrier
                # data_pos[rx_gather[i]] = class output row rx_gather[i]
                # -> class flat position flat_off + rx_gather[i]*nc + ci
                f0 = sym_cell_off[r]
                layout[f0:f0 + n_data_c] = (flat_off
                                            + rxg.astype(np.int64) * nc
                                            + ci)
            self.classes.append(_Class(
                np.array(rows, np.int32), pilot_rows.astype(np.int32),
                inv_ref, stencil, comp.astype(np.int32), miso=miso))
            flat_off += n_data_c * nc
        self.layout = layout
        self.total_cells = total
        # symbol emission order that makes every class's symbols
        # CONTIGUOUS: a front end built with sym_order=this (free — its
        # per-symbol scan reads the grid permuted) lets the syms entry
        # slice classes as contiguous column views instead of strided
        # middle-axis copies (~0.14 ms/frame at the 32K bench shape)
        self.sym_order = np.concatenate(
            [np.asarray(c.sym_cols) for c in self.classes]).astype(np.int32)
        # fftshift-wrapped row tables: carrier row r lives at FFT output
        # row (s0 + r) % fft, so the comp-first path can index the raw
        # carrier-major FFT output directly and skip the to_carriers
        # concat pass entirely
        s0 = (p.left_nulls - p.fft_size // 2) % p.fft_size
        for c in self.classes:
            c.pilot_rows_wrapped = ((s0 + c.pilot_rows) % p.fft_size
                                    ).astype(np.int32)
            c.comp_rows_wrapped = ((s0 + c.comp_rows) % p.fft_size
                                   ).astype(np.int32)
        if p.miso:
            self._resolve_miso_partners()
        self._fn = jax.jit(self._build())

    def _resolve_miso_partners(self):
        """Finish the MISO class metadata: for each class and each subset
        (sum = non-inverted pilots, dif = inverted), pick the channel
        SOURCE.  On data symbols the inversion parity equals the row
        parity, so one subset per class is just the few continual pilots —
        useless against a frequency-selective channel; that subset's
        channel is taken from the class of ADJACENT symbols (rows +-1),
        where it is dense, lane-aligned to the nearest partner symbol
        (static channel across neighbouring symbols).  P2/FC classes have
        alternating inversions and stay self-contained."""
        p = self.p
        k_total = p.k_total

        def density_ok(pos):
            # dense enough to follow a selective channel: max pilot gap
            # bounded by a few scattered-pilot spacings
            if len(pos) < 8:
                return False
            dx, dy = tables.SP_PATTERN[p.pilot_pattern]
            return int(np.diff(np.sort(pos)).max()) <= 4 * dx * dy

        for ci, c in enumerate(self.classes):
            mi = c.miso
            inv = mi.pop("inverted")
            mi["self_idx"] = ci
            for side, mask in (("sum", ~inv), ("dif", inv)):
                sel = np.nonzero(mask)[0].astype(np.int32)
                pos = c.pilot_rows[mask]
                src_idx, lane_map, nc_src = None, None, None
                if not density_ok(pos):
                    # find a partner class whose matching subset is dense
                    best = None
                    for pj, pc in enumerate(self.classes):
                        if pj == ci or pc.miso is None:
                            continue
                        pinv = pc.miso.get("inverted")
                        if pinv is None:   # already resolved: recompute
                            pinv = pc.miso["_inv_cache"]
                        pmask = ~pinv if side == "sum" else pinv
                        ppos = pc.pilot_rows[pmask]
                        if not density_ok(ppos):
                            continue
                        # temporal distance between the class's symbols
                        dist = abs(int(pc.sym_cols[0]) - int(c.sym_cols[0]))
                        if best is None or dist < best[0]:
                            best = (dist, pj, pmask, ppos)
                    if best is not None:
                        _, pj, pmask, ppos = best
                        pc = self.classes[pj]
                        src_idx = pj
                        sel = np.nonzero(pmask)[0].astype(np.int32)
                        pos = ppos
                        # nearest partner symbol per own symbol
                        lane_map = np.array(
                            [int(np.argmin(np.abs(
                                np.asarray(pc.sym_cols) - r)))
                             for r in c.sym_cols], np.int32)
                        nc_src = int(pc.count)
                il, ir, w = _interp_stencil(np.sort(pos), k_total)
                order = np.argsort(pos)
                mi[side] = dict(src_idx=src_idx, sel=sel[order],
                                stencil=(il, ir, w.reshape(-1, 1)),
                                lane_map=lane_map, nc_src=nc_src)
            mi["_inv_cache"] = inv

    def _build(self):
        p = self.p
        classes = self.classes

        def run(body2):
            body = jax.lax.complex(body2[:, 0], body2[:, 1])
            sym = body.reshape(p.len_frame, p.symbol_size)[:, p.guard_size:]
            spec = jnp.fft.fftshift(jnp.fft.fft(sym, axis=1), axes=1)
            car = spec[:, p.left_nulls:p.left_nulls + p.k_total]
            xr = jnp.real(car).T                         # (k_total, n_sym)
            xi = jnp.imag(car).T
            xs = [(xr[:, c.sym_cols], xi[:, c.sym_cols]) for c in classes]
            ests = None
            if p.miso:
                # MISO: every class's pilot estimates first (partner
                # classes source their sparse subset from neighbours)
                ests = [class_pilot_est(c, a, b, 1)
                        for c, (a, b) in zip(classes, xs)]
            outs_r, outs_i = [], []
            for c, (a, b) in zip(classes, xs):
                er, ei = _eq_class_planar(c, a, b, 1, ests=ests)
                outs_r.append(er.reshape(-1))
                outs_i.append(ei.reshape(-1))
            return jnp.stack([jnp.concatenate(outs_r),
                              jnp.concatenate(outs_i)], axis=-1)

        return run


class FusedPLPPath:
    """Class-layout cells -> (n_ldpc, B) codeword LLRs for one PLP."""

    def __init__(self, p: T2Params, plp: PLPParams, num_blocks: int,
                 demod: FusedFrameDemod, plp_start_cell: int = 0,
                 l1_cells: int | None = None, sub_slices: int = 1,
                 slice_interval: int = 0):
        self.plp = plp
        self.num_blocks = num_blocks
        cpf = plp.cells_per_fec_block
        from .decode import _ti_inverse_perm
        from ..tx.frame import ti_blocks_split
        n_ti = max(1, plp.time_il_length if plp.time_il_type == 0 else 1)
        perms = []
        off = 0
        for nb in ti_blocks_split(num_blocks, n_ti):
            if nb == 0:
                continue
            perms.append(_ti_inverse_perm(cpf, nb) + off)
            off += nb * cpf
        ti = np.concatenate(perms).astype(np.int64)
        if l1_cells is None:
            pre, _ = l1mod.build_l1(p, [plp])
            l1_cells = l1mod.L1_PRE_CELLS + pre.l1_post_size
        # plain-cell position of PLP-stream cell j: type-2 PLPs are cut
        # into sub_slices round-robin slices `slice_interval` cells apart
        # (the reference's slice switching, time_deinterleaver.cpp:354-366)
        n_cells = num_blocks * cpf
        j = np.arange(n_cells, dtype=np.int64)
        if sub_slices > 1:
            ln = n_cells // sub_slices
            substream = (plp_start_cell + (j // ln) * slice_interval
                         + (j % ln))
        else:
            substream = plp_start_cell + j
        # compose: plain cell i <- class-flat position
        self.comp = demod.layout[l1_cells + substream[ti]].astype(np.int32)
        fec = plp.fec
        addr = interleavers.bit_interleaver_perm(plp.constellation,
                                                plp.fec_frame, plp.rate)
        pperm = interleavers.parity_interleaver_perm(fec.n_ldpc, fec.k_ldpc,
                                                    fec.q_ldpc)
        g = pperm[addr]
        g_inv = np.empty_like(g)
        g_inv[g] = np.arange(len(g), dtype=np.int32)
        self.bit_inv = g_inv
        self.rot = np.exp(-1j * tables.ROTATION_ANGLE[plp.constellation]) \
            if plp.rotated else 1.0
        self._fn = jax.jit(self._build())

    def _build(self):
        plp = self.plp
        m = plp.bits_per_cell
        half = m // 2
        cpf = plp.cells_per_fec_block
        nb = self.num_blocks
        comp = self.comp
        bit_inv = self.bit_inv
        rot_re = np.float32(np.real(self.rot))
        rot_im = np.float32(np.imag(self.rot))
        from ..dvbt2.tables import NORM_FACTOR, _gray_levels
        levels = (_gray_levels(m) * NORM_FACTOR[plp.constellation]
                  ).astype(np.float32)
        words = np.arange(len(levels))
        axis_masks = np.stack(
            [(words >> (half - 1 - b)) & 1 for b in range(half)]).astype(bool)
        inf = np.float32(1e30)

        def axis_llrs(xax, inv_nvar):
            d2 = (xax[:, None] - levels[None, :]) ** 2
            out = []
            for b in range(half):
                d0 = jnp.min(jnp.where(axis_masks[b][None, :], inf, d2),
                             axis=1)
                d1 = jnp.min(jnp.where(axis_masks[b][None, :], d2, inf),
                             axis=1)
                out.append((d1 - d0) * inv_nvar)
            return jnp.stack(out, axis=1)

        def run(flat2, inv_nvar):
            cells = flat2[comp]                          # (nb*cpf, 2)
            re = cells[:, 0].reshape(nb, cpf)
            im = cells[:, 1].reshape(nb, cpf)
            if plp.rotated:
                im = jnp.roll(im, -1, axis=-1)
                re, im = (re * rot_re - im * rot_im,
                          re * rot_im + im * rot_re)
            li = axis_llrs(re.reshape(-1), inv_nvar)     # (n, half)
            lq = axis_llrs(im.reshape(-1), inv_nvar)
            v = jnp.stack([li, lq], axis=2).reshape(nb, cpf * m)
            vt = v.T                                     # (n_ldpc, nb)
            return vt[bit_inv, :]                        # row gather

        return run


class MultiFramePath:
    """F-frame batched demod + PLP path, carrier-major with the frame axis
    folded into the *row width* of every gather.

    A row gather costs about the same per index whatever the row width,
    so the per-frame cost of the big PLP cell permutation (nb*cpf
    composed indices) scales as 1/F: all arrays keep (..., F) minor so
    each gathered row carries all F frames.

    fn(bodies (F, len_frame*symbol_size, 2), inv_nvar)
      -> (n_ldpc, nb, F) LLRs; feed each frame's (n_ldpc, nb) slice to the
      LDPC decoder.

    With emit_l1 / emit_evm the call returns a tuple
    (llrs[, l1_cells (l1_size, F, 2)][, evm (F,)]): the L1 region for host
    per-frame signalling parse and the mean min-distance EVM (the blind
    noise/SNR estimate, llr_demapper.cpp:184-196) feeding the next
    superstep's inv_nvar — what the streaming device path consumes.

    Multi-PLP: pass `plp_specs` = [(plp, num_blocks, start_cell,
    sub_slices, slice_interval), ...] to decode every PLP of the frame
    batch in the SAME superstep — the one demod feeds each PLP's composed
    gather + LLR tail (the reference's multi-PLP slice switching at rate,
    time_deinterleaver.cpp:354-366).  The llrs result becomes a tuple of
    per-PLP (n_ldpc_p, nb_p, F) arrays and the EVM is cell-weighted over
    all PLPs.
    """

    def __init__(self, p: T2Params, plp: PLPParams | None = None,
                 num_blocks: int = 0,
                 n_frames: int = 1, llr_dtype=jnp.float32,
                 emit_l1: bool = False, emit_evm: bool = False,
                 plp_start_cell: int = 0, l1_cells: int | None = None,
                 demod_dtype=None, plp_specs=None):
        self.p = p
        self.n_frames = n_frames
        self.llr_dtype = llr_dtype
        # demod compute/storage dtype: bf16 halves the HBM traffic of the
        # (bandwidth-bound) FFT/equalizer stages; quantization sits at
        # ~-40 dB EVM, under the FEC margin at every operating point
        self.demod_dtype = demod_dtype or llr_dtype
        self.emit_l1 = emit_l1
        self.emit_evm = emit_evm
        self.demod = get_fused_demod(p)
        self.multi = plp_specs is not None
        if plp_specs is None:
            plp_specs = [(plp, num_blocks, plp_start_cell, 1, 0)]
        self.specs = list(plp_specs)
        self.plp = self.specs[0][0]
        self.num_blocks = self.specs[0][1]
        if l1_cells is not None:
            self.l1_size = l1_cells
        else:
            from ..dvbt2 import l1 as l1mod
            pre, _ = l1mod.build_l1(p, [s[0] for s in self.specs])
            self.l1_size = l1mod.L1_PRE_CELLS + pre.l1_post_size
        self.paths = []
        for (pl, nb, sc, ss, iv) in self.specs:
            if sc == 0 and ss == 1 and l1_cells is None \
                    and len(self.specs) == 1:
                self.paths.append(get_fused_plp_path(p, pl, nb))
            else:
                self.paths.append(FusedPLPPath(
                    p, pl, nb, self.demod, plp_start_cell=sc,
                    l1_cells=self.l1_size, sub_slices=ss,
                    slice_interval=iv))
        self.single = self.paths[0]
        built = self._build()
        self._fn = jax.jit(built)
        # planar-pairs avoided INSIDE the path since round 2; the planes
        # entry extends that to the input boundary (the (F, n, 2) stack
        # itself costs a tile-padded pass at 32K scale), and the syms
        # entry takes GI-stripped symbols straight from the front end
        self._fn_planes = jax.jit(built.planes)
        self._fn_syms = jax.jit(built.syms)

    def _make_tail(self, path: FusedPLPPath):
        """Per-PLP LLR tail: class-flat planar rows -> (n_ldpc, nb, F)
        LLRs + per-frame mean min distance (EVM)."""
        plp = path.plp
        nb = path.num_blocks
        f = self.n_frames
        cpf = plp.cells_per_fec_block
        m = plp.bits_per_cell
        half = m // 2
        # cell-major ordering of the composed PLP permutation so the LLR
        # pipeline keeps (nb, F) minor and never transposes them
        comp_cm = path.comp.reshape(nb, cpf).T.reshape(-1)
        # bit deinterleave remapped to PLANE-MAJOR LLR storage: axis_llrs
        # naturally emits (half, cpf, nb, F) per axis; gathering straight
        # from the concatenated plane-major stack skips the
        # stack(axis=1)+transpose passes over the full LLR volume.
        # v-flat index = cell*m + bitpos (bits interleave I/Q:
        # y0=I0,y1=Q0,y2=I1,...); plane-major index = plane*cpf + cell
        # with plane = axis*half + bit_of_axis
        bi = path.bit_inv.astype(np.int64)
        cell_ix, bitpos = bi // m, bi % m
        plane = (bitpos % 2) * half + bitpos // 2
        bit_inv_pm = (plane * cpf + cell_ix).astype(np.int32)
        llr_dtype = self.llr_dtype
        # python-float constants keep weak typing so bf16 stays bf16
        rot_re = float(np.real(path.rot))
        rot_im = float(np.imag(path.rot))
        from ..dvbt2.tables import NORM_FACTOR, _gray_levels
        levels = [float(v) for v in
                  _gray_levels(m) * NORM_FACTOR[plp.constellation]]
        words = np.arange(len(levels))
        axis_masks = np.stack(
            [(words >> (half - 1 - b)) & 1 for b in range(half)]).astype(bool)

        def axis_llrs(xax, inv_nvar):
            # explicit level loop: never materializes a (2^half, ...)
            # distance tensor (2+ GB at F=128), and accumulates the
            # per-bit min distances in llr_dtype -- bf16 on the device
            # path, comparable to the reference's int8 LLR quantization
            # (llr_demapper.cpp:770-776)
            acc0 = [None] * half
            acc1 = [None] * half
            for lvl_i, lvl in enumerate(levels):
                d = ((xax - lvl) ** 2).astype(llr_dtype)
                for b in range(half):
                    if axis_masks[b][lvl_i]:
                        acc1[b] = d if acc1[b] is None \
                            else jnp.minimum(acc1[b], d)
                    else:
                        acc0[b] = d if acc0[b] is None \
                            else jnp.minimum(acc0[b], d)
            inv_t = inv_nvar.astype(llr_dtype)
            llrs = jnp.stack([(acc1[b] - acc0[b]) * inv_t
                              for b in range(half)], axis=0)
            # bit-0 partitions ALL levels: its two accumulators together
            # hold the unconditional min distance (per-axis EVM), free here
            mind = jnp.minimum(acc0[0], acc1[0])
            return llrs, mind

        def tail(both, inv_nvar):
            # ONE row gather for both planes: the composed-permutation
            # gather is INDEX-rate bound (~1e8 rows/s regardless of row
            # width), so the PAIRED (total, 2F) class-flat layout halves
            # its cost vs two per-plane gathers
            g = both[comp_cm].reshape(cpf, nb, 2, f)
            re, im = g[:, :, 0, :], g[:, :, 1, :]
            if plp.rotated:
                im = jnp.roll(im, -1, axis=0)      # cyclic Q-delay per block
                re, im = (re * rot_re - im * rot_im,
                          re * rot_im + im * rot_re)
            li, mi_ = axis_llrs(re, inv_nvar)      # (half, cpf, nb, F) bf16
            lq, mq_ = axis_llrs(im, inv_nvar)
            # plane-major LLR stack + remapped bit deinterleave: no
            # interleave transpose over the (n_ldpc, nb, F) volume
            v = jnp.concatenate([li, lq], axis=0).reshape(m * cpf, nb, f)
            out = v[bit_inv_pm]                    # row gather (n_ldpc,nb,F)
            evm = (jnp.mean(mi_.astype(jnp.float32), axis=(0, 1))
                   + jnp.mean(mq_.astype(jnp.float32), axis=(0, 1)))
            return out, evm                        # evm: (F,)

        return tail

    def _build(self):
        p = self.p
        f = self.n_frames
        classes = self.demod.classes
        dd = self.demod_dtype
        tails = [self._make_tail(pa) for pa in self.paths]
        # cell-count weights for the cross-PLP EVM average
        wts = np.array([pa.num_blocks * pa.plp.cells_per_fec_block
                        for pa in self.paths], np.float64)
        wts = (wts / wts.sum()).tolist()
        multi = self.multi

        emit_l1 = self.emit_l1
        emit_evm = self.emit_evm
        l1_rows = self.demod.layout[:self.l1_size].astype(np.int32)

        sym_off = np.concatenate(
            [[0], np.cumsum([c.count for c in classes])]).astype(int)

        def run_syms(sym_r, sym_i, inv_nvar):
            # entry for GI-stripped (F, len_frame, fft) symbol planes in
            # CLASS ORDER (demod.sym_order): the fused front end emits
            # them this way for free, turning the per-class strided
            # slices below into contiguous column views
            return run_core(sym_r, sym_i, inv_nvar, ordered=True)

        def run_planes(body_r, body_i, inv_nvar):
            # planar f32 end-to-end: complex arrays would add whole-array
            # pack/split passes, tile poorly with small trailing dims, and
            # XLA's complex divide is branch-heavy
            sym_r = body_r.reshape(f, p.len_frame, p.symbol_size
                                   )[:, :, p.guard_size:]
            sym_i = body_i.reshape(f, p.len_frame, p.symbol_size
                                   )[:, :, p.guard_size:]
            return run_core(sym_r, sym_i, inv_nvar)

        def run_core(sym_r, sym_i, inv_nvar, ordered=False):
            # OFDM FFT (cuFFT on the GPU) into the carrier-major layout;
            # fftshift + active-carrier slice become two wrapped row
            # slices of the k-major layout
            xkr, xki = fft_carrier_major(sym_r, sym_i, dd)  # (fft, n_sym, F)
            s0 = (p.left_nulls - p.fft_size // 2) % p.fft_size

            def to_carriers(v):
                if s0 + p.k_total <= p.fft_size:
                    return v[s0:s0 + p.k_total]
                return jnp.concatenate(
                    [v[s0:], v[:s0 + p.k_total - p.fft_size]], axis=0)

            # comp-first route (ordered SISO): the class row tables carry
            # the fftshift wrap, so the raw FFT output is indexed
            # directly — no to_carriers concat pass
            comp_first = ordered and not p.miso
            if comp_first:
                xr, xi = xkr, xki                      # (fft, n_sym, F)
            else:
                xr = to_carriers(xkr)                  # (k, n_sym, F)
                xi = to_carriers(xki)

            def class_slices(c):
                # flatten (nc, F) into one dense lane axis: (nc=10, F) minor
                # dims tile as padded (16, 128) blocks, tripling the traffic
                # of every elementwise op in this loop
                nw = c.count * f
                sl = lambda a: jax.lax.slice_in_dim(
                    a, c.start, c.start + c.step * (c.count - 1) + 1,
                    c.step, axis=1).reshape(-1, nw)  # (k, nc*F)
                return sl(xr), sl(xi)

            def class_slices_ordered(ci, c):
                # class-ordered symbols: contiguous column view of the
                # (k, n_sym*F) merged lane axis — no strided copy
                o = int(sym_off[ci])
                sl = lambda a: jax.lax.slice_in_dim(
                    a.reshape(a.shape[0], -1), o * f, (o + c.count) * f,
                    axis=1)
                return sl(xr), sl(xi)

            if ordered:
                xs = [class_slices_ordered(ci, c)
                      for ci, c in enumerate(classes)]
            else:
                xs = [class_slices(c) for c in classes]
            ests = None
            if p.miso:
                ests = [class_pilot_est(c, a, b, f)
                        for c, (a, b) in zip(classes, xs)]
            # PAIRED class-flat layout (total, 2F): row j = [re_j | im_j].
            # The EQ fuses into this single write (per-class minor-axis
            # concat), and the tails' composed cell gather reads 2F-wide
            # rows — no separate fr/fi materialization + re-pairing pass
            outs = []
            for c, (a, b) in zip(classes, xs):
                if comp_first:
                    eqr, eqi = _eq_class_comp(c, a, b, f, wrapped=True)
                else:
                    eqr, eqi = _eq_class_planar(c, a, b, f, ests=ests)
                outs.append(jnp.concatenate(
                    [eqr.reshape(-1, f), eqi.reshape(-1, f)], axis=1))
            both = jnp.concatenate(outs, axis=0)   # (total, 2F)
            outs, evms = [], []
            for w, tail in zip(wts, tails):
                out_p, evm_p = tail(both, inv_nvar)
                outs.append(out_p)
                evms.append(evm_p * w)
            out = tuple(outs) if multi else outs[0]
            if not (emit_l1 or emit_evm):
                return out
            res = [out]
            if emit_l1:
                l1c = both[l1_rows]
                res.append(jnp.stack([l1c[:, :f], l1c[:, f:]], axis=-1))
            if emit_evm:
                res.append(sum(evms))              # (F,) cell-weighted
            return tuple(res)

        def run(bodies, inv_nvar):
            return run_planes(bodies[..., 0], bodies[..., 1], inv_nvar)

        run.planes = run_planes
        run.syms = run_syms
        return run

    def __call__(self, bodies, inv_nvar):
        return self._fn(bodies, inv_nvar)


def fft_carrier_major(sym_r, sym_i, dtype):
    """(F, S, n) planar time-domain symbols -> (n, S, F) planar spectra in
    the carrier-major layout the equalizer reads (jnp.fft: cuFFT on the
    GPU, complex64 in and out).  On the H100 it measured faster inside
    the bench superstep than the matmul-factorised FFT it replaced
    (PERF.md)."""
    x = jax.lax.complex(sym_r.astype(jnp.float32), sym_i.astype(jnp.float32))
    spec = jnp.transpose(jnp.fft.fft(x, axis=-1), (2, 1, 0))
    return jnp.real(spec).astype(dtype), jnp.imag(spec).astype(dtype)


@functools.lru_cache(maxsize=None)
def get_fused_demod(p: T2Params) -> FusedFrameDemod:
    return FusedFrameDemod(p)


@functools.lru_cache(maxsize=None)
def get_fused_plp_path(p: T2Params, plp: PLPParams,
                       num_blocks: int) -> FusedPLPPath:
    return FusedPLPPath(p, plp, num_blocks, get_fused_demod(p))
