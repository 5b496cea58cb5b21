"""Jitted device demod path: frame samples -> codeword LLRs (JAX/XLA).

The first device path (SURVEY.md §7 step 5 precursor).  Everything the
NumPy oracle in `rx.demod`/`rx.decode` does per frame is restructured as
static-shape batched tensor ops so XLA can fuse and tile it:

  - GI strip: reshape + static slice
  - FFT: one batched jnp.fft.fft over (n_sym, fft_size)
  - channel estimation: pilot gathers + precomputed linear-interp stencils
    (idx_left/idx_right/weight per carrier -- host-precomputed, so on device
    interpolation is two gathers and an FMA; no sorting, no searchsorted)
  - equalize + frequency deinterleave + frame cell concat: gathers
  - TI/cell deinterleave, Q-delay, derotation: one combined gather per PLP
  - LLR demap: distance to all constellation points + per-bit min
  - bit+parity deinterleave: one combined gather

Symbols are grouped by type (P2 / data / FC) so each group is a uniform
batch with identical index-table shapes.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..dvbt2 import interleavers, tables
from ..dvbt2.params import PLPParams, T2Params
from . import demod as npdemod

_INF = np.float32(1e30)


def _interp_stencil(pilot_pos: np.ndarray, k_total: int):
    """For each carrier k: (left_idx, right_idx, weight_right) into the
    pilot array, linear interpolation with edge clamping."""
    right = np.searchsorted(pilot_pos, np.arange(k_total), side="left")
    right = np.clip(right, 0, len(pilot_pos) - 1)
    left = np.clip(right - 1, 0, len(pilot_pos) - 1)
    on_pilot = pilot_pos[right] == np.arange(k_total)
    left = np.where(on_pilot, right, left)
    denom = (pilot_pos[right] - pilot_pos[left]).astype(np.float32)
    denom[denom == 0] = 1.0
    w = (np.arange(k_total) - pilot_pos[left]).astype(np.float32) / denom
    w = np.clip(w, 0.0, 1.0)
    return left.astype(np.int32), right.astype(np.int32), w


@dataclass
class _SymGroup:
    rows: np.ndarray          # symbol indices in the frame
    pilot_pos: np.ndarray     # (g, n_pilots)
    pilot_ref: np.ndarray     # (g, n_pilots) complex64
    data_pos: np.ndarray      # (g, n_data)
    rx_gather: np.ndarray     # (g, n_data)
    il: tuple                 # interp stencils (g, k_total) x3


class FrameDemod:
    """Precomputed tables + jitted samples->cells pipeline for one mode."""

    def __init__(self, p: T2Params):
        self.p = p
        tabs = npdemod.pilot_tables(p)
        groups = []
        # group symbols with identical table shapes: P2s / plain data / FC
        n_plain = p.n_data - (1 if p.has_fc else 0)
        spans = [list(range(p.n_p2)),
                 list(range(p.n_p2, p.n_p2 + n_plain))]
        if p.has_fc:
            spans.append([p.len_frame - 1])
        for rows in spans:
            if not rows:
                continue
            pp = np.stack([tabs[r]["pilot_pos"] for r in rows])
            pr = np.stack([tabs[r]["pilot_ref"] for r in rows])
            dp = np.stack([tabs[r]["data_pos"] for r in rows])
            rg = np.stack([tabs[r]["rx_gather"] for r in rows])
            st = [np.stack(x) for x in zip(
                *[_interp_stencil(tabs[r]["pilot_pos"], p.k_total)
                  for r in rows])]
            groups.append(_SymGroup(np.array(rows), pp, pr, dp, rg,
                                    tuple(st)))
        self.groups = groups
        self._fn = jax.jit(self._build())

    def _build(self):
        p = self.p
        # NB constants stay host NumPy: jit embeds them in the program.  The
        # kernel boundary is float pairs and pilot references are kept as
        # their real values (DVB-T2 pilots are BPSK: imag == 0).
        g_const = [(g.rows, g.pilot_pos,
                    np.real(g.pilot_ref).astype(np.float32), g.data_pos,
                    g.rx_gather, g.il)
                   for g in self.groups]

        def run(body2: jnp.ndarray) -> jnp.ndarray:
            """body2: (len_frame*symbol_size, 2) float32 -> cells (n, 2)."""
            body = jax.lax.complex(body2[:, 0], body2[:, 1])
            sym = body.reshape(p.len_frame, p.symbol_size)[:, p.guard_size:]
            spec = jnp.fft.fftshift(jnp.fft.fft(sym, axis=1), axes=1)
            carriers = spec[:, p.left_nulls:p.left_nulls + p.k_total]
            cells = []
            for rows, ppos, pref, dpos, rgat, (il, ir, w) in g_const:
                rowsc = carriers[rows]                     # (g, k_total)
                est_p = jnp.take_along_axis(rowsc, ppos, axis=1) / pref
                est = (jnp.take_along_axis(est_p, il, axis=1) * (1 - w)
                       + jnp.take_along_axis(est_p, ir, axis=1) * w)
                eq = rowsc / est
                data = jnp.take_along_axis(eq, dpos, axis=1)
                deint = jnp.take_along_axis(data, rgat, axis=1)
                cells.append(deint.reshape(-1))
            out = jnp.concatenate(cells)
            return jnp.stack([jnp.real(out), jnp.imag(out)], axis=-1)

        return run

    def __call__(self, frame_body: np.ndarray) -> jnp.ndarray:
        """frame_body: (len_frame*symbol_size,) complex64 (P1 stripped) on
        host.  Returns (cells_per_frame,) complex64 on host."""
        pair = np.stack([np.real(frame_body), np.imag(frame_body)],
                        axis=-1).astype(np.float32)
        out = np.asarray(self._fn(pair))
        return (out[:, 0] + 1j * out[:, 1]).astype(np.complex64)


class PLPDecodePath:
    """Jitted cells->codeword-LLRs for one PLP at a fixed num_blocks."""

    def __init__(self, plp: PLPParams, num_blocks: int):
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
        self.ti_perm = np.concatenate(perms)
        fec = plp.fec
        addr = interleavers.bit_interleaver_perm(plp.constellation,
                                                plp.fec_frame, plp.rate)
        pperm = interleavers.parity_interleaver_perm(fec.n_ldpc, fec.k_ldpc,
                                                    fec.q_ldpc)
        g = pperm[addr]                      # TX: v = cw[g]
        g_inv = np.empty_like(g)
        g_inv[g] = np.arange(len(g), dtype=np.int32)
        self.bit_gather = g                  # RX gather: cw = v[g_inv]
        self.bit_inv = g_inv
        self.pts = tables.constellation_points(plp.constellation)
        self.rot = np.exp(-1j * tables.ROTATION_ANGLE[plp.constellation]) \
            if plp.rotated else 1.0
        self._fn = jax.jit(self._build())

    def _build(self):
        plp = self.plp
        m = plp.bits_per_cell
        half = m // 2
        cpf = plp.cells_per_fec_block
        nb = self.num_blocks
        ti_perm = self.ti_perm
        bit_inv = self.bit_inv
        rot_re = np.float32(np.real(self.rot))
        rot_im = np.float32(np.imag(self.rot))
        # separable demap: square gray QAM -> per-axis PAM levels; I carries
        # the even cell-word bits (y0,y2,..), Q the odd ones.  16x less work
        # than the full 2D distance matrix, exactly equal in max-log.
        from ..dvbt2.tables import NORM_FACTOR, _gray_levels
        levels = (_gray_levels(m) * NORM_FACTOR[plp.constellation]
                  ).astype(np.float32)                       # (2^half,)
        words = np.arange(len(levels))
        axis_masks = np.stack(
            [(words >> (half - 1 - b)) & 1 for b in range(half)]
        ).astype(bool)                                       # (half, 2^half)
        lv = levels

        def axis_llrs(x, inv_nvar):
            """x: (n,) PAM observations -> (n, half) LLRs."""
            d2 = (x[:, None] - lv[None, :]) ** 2             # (n, 2^half)
            out = []
            for b in range(half):
                d0 = jnp.min(jnp.where(axis_masks[b][None, :], _INF, d2),
                             axis=1)
                d1 = jnp.min(jnp.where(axis_masks[b][None, :], d2, _INF),
                             axis=1)
                out.append((d1 - d0) * inv_nvar)
            return jnp.stack(out, axis=1)

        def run(slice2: jnp.ndarray, inv_nvar: jnp.ndarray):
            """slice2: (n_cells, 2) float32."""
            re = slice2[ti_perm, 0].reshape(nb, cpf)
            im = slice2[ti_perm, 1].reshape(nb, cpf)
            if plp.rotated:
                im = jnp.roll(im, -1, axis=-1)
                re, im = (re * rot_re - im * rot_im,
                          re * rot_im + im * rot_re)
            flat_re = re.reshape(-1)
            flat_im = im.reshape(-1)
            li = axis_llrs(flat_re, inv_nvar)                # (n, half)
            lq = axis_llrs(flat_im, inv_nvar)
            # interleave: y0 from I, y1 from Q, y2 from I, ...
            v = jnp.stack([li, lq], axis=2).reshape(flat_re.shape[0], m)
            v = v.reshape(nb, cpf * m)
            return v[:, bit_inv]

        return run

    def __call__(self, slice_cells, inv_nvar):
        """slice_cells: (num_blocks*cells_per_fec,) complex on host ->
        (nb, n_ldpc) LLR array."""
        pair = np.stack([np.real(slice_cells), np.imag(slice_cells)],
                        axis=-1).astype(np.float32)
        return self._fn(pair, inv_nvar)


@functools.lru_cache(maxsize=None)
def get_frame_demod(p: T2Params) -> FrameDemod:
    return FrameDemod(p)


@functools.lru_cache(maxsize=None)
def get_plp_path(plp: PLPParams, num_blocks: int) -> PLPDecodePath:
    return PLPDecodePath(plp, num_blocks)
