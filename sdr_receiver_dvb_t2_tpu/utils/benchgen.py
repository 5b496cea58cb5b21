"""Device-side synthesis of DISTINCT per-frame T2 waveforms for benching.

The throughput bench needs F frames with F distinct payloads (a frame-axis
permutation bug must fail its gate), and modulating F frames on the host
takes seconds per frame.  Instead the host ships ONE frame's ingredients and the device synthesizes
frame f by cyclically rolling the FEC-block axis by f:

  - the pre-interleave cell stream (rotation/Q-delay already applied —
    both are per-FEC-block, so whole-block rolls commute with them),
  - the composed cell+time-interleave + framing + frequency-interleave
    map, probed through the real TX chain (a pure permutation),
  - the L1 + pilot + dummy-cell overlay (identical every frame),
  - the P1 preamble.

Frame f's slot b then carries original codeword (b + f) mod nb — a valid
DVB-T2 frame with unique bytes at every (frame, slot).
"""
from __future__ import annotations

import numpy as np

from ..dvbt2 import l1 as l1mod
from ..dvbt2.params import PLPParams, T2Params
from ..tx import fec as txfec
from ..tx import frame as txframe


def probe_maps(p: T2Params, plp: PLPParams, l1_arr: np.ndarray,
               cells0: np.ndarray):
    """Probe the TX interleave+framing chain for the composed map.

    cells0: (nb, cpf) rotated/Q-delayed cells (tx.fec.plp_encode output).
    Returns (stream0 (nb*cpf,) complex, cellmap (len_frame, k_total) int64
    with -1 = overlay position, overlay (len_frame, k_total) complex).
    Asserts the decomposition reproduces the direct modulator's carriers.
    """
    nb, cpf = cells0.shape
    n_cells = nb * cpf
    probe_slice = txframe.interleave_plp_frame(
        plp, (np.arange(n_cells, dtype=np.float64) + 1.0
              ).astype(np.complex64).reshape(nb, cpf))
    carriers_probe = txframe.symbols_to_carriers(
        p, txframe.cells_to_symbols(
            p, txframe.build_frame_cells(p, l1_arr, [probe_slice])))
    overlay = txframe.symbols_to_carriers(
        p, txframe.cells_to_symbols(
            p, txframe.build_frame_cells(
                p, l1_arr, [np.zeros(n_cells, np.complex64)])))
    diff = carriers_probe - overlay
    is_cell = np.abs(diff) > 0.5
    cellmap = np.full(overlay.shape, -1, np.int64)
    cellmap[is_cell] = np.round(np.real(diff[is_cell])).astype(np.int64) - 1
    assert (np.sort(cellmap[is_cell]) == np.arange(n_cells)).all()
    # cross-check against the direct modulator path
    sl0 = txframe.interleave_plp_frame(plp, cells0)
    carriers_ref = txframe.symbols_to_carriers(
        p, txframe.cells_to_symbols(
            p, txframe.build_frame_cells(p, l1_arr, [sl0])))
    stream0 = cells0.reshape(-1)
    recon = overlay.copy()
    recon[is_cell] = recon[is_cell] + stream0[cellmap[is_cell]]
    assert np.allclose(recon, carriers_ref, atol=1e-5)
    return stream0, cellmap, overlay


def make_frame_synth(p: T2Params, cpf: int, n_frames: int,
                     stream0: np.ndarray, cellmap: np.ndarray,
                     overlay: np.ndarray, p1: np.ndarray):
    """Jittable device synthesis: () -> (F, frame_samples) complex frames,
    frame f = roll-by-f codewords.  Ships the ingredients as int16-coded
    device constants (a quarter of the complex64 bytes).

    Returns (synth_fn, ship) where ship is a dict of device arrays to pass
    to synth_fn (kept explicit so the caller controls the one-time
    transfer).
    """
    import jax
    import jax.numpy as jnp

    s_scale = float(np.max(np.abs(np.stack([stream0.real, stream0.imag]))))
    o_scale = float(np.max(np.abs(np.stack([overlay.real, overlay.imag]))))
    p_scale = float(np.max(np.abs(np.stack([p1.real, p1.imag]))))
    ship = dict(
        stream=jnp.asarray(np.round(np.stack(
            [stream0.real, stream0.imag], axis=-1) / s_scale * 32000.0
        ).astype(np.int16)),
        overlay=jnp.asarray(np.round(np.stack(
            [overlay.real, overlay.imag], axis=-1) / o_scale * 32000.0
        ).astype(np.int16)),
        cmap=jnp.asarray(cellmap.reshape(-1).astype(np.int32)),
        p1=jnp.asarray(np.round(np.stack(
            [p1.real, p1.imag], axis=-1) / p_scale * 32000.0
        ).astype(np.int16)),
    )
    body_len = p.frame_samples - 2048

    nb = len(stream0) // cpf
    if n_frames > nb:
        # the doubled stream covers roll offsets 0..nb only; beyond that
        # the row gather would silently clamp and duplicate payloads
        raise ValueError(f"n_frames ({n_frames}) must be <= the FEC-block "
                         f"count ({nb}) for distinct per-frame rolls")

    def synth(ship):
        # PLANAR SEPARATED re/im throughout, and NO stacked 1-D slices:
        # stacking n_frames column slices makes XLA materialize (n, 1)
        # column copies tiled to (8, 128) blocks — a 64-128x HBM padding
        # blowup that OOMs the chip at 32K scale.  Instead the roll
        # structure is expressed as row arithmetic: with cell index
        # i = a*cpf + b, frame f's rolled stream is S3[a + f, b] over the
        # doubled stream reshaped to whole FEC blocks — ONE row gather.
        cmap = ship["cmap"]
        safe = jnp.maximum(cmap, 0)
        neg = (cmap < 0)[:, None]
        rows = (jnp.arange(nb)[:, None]
                + jnp.arange(n_frames)[None, :]).reshape(-1)  # (nb*F,)

        def plane(v, scale, o):
            s = v.astype(jnp.float32) * jnp.float32(scale)
            s3 = jnp.concatenate([s, s], axis=0).reshape(2 * nb, cpf)
            w = s3[rows]                          # (nb*F, cpf) row gather
            r = jnp.transpose(w.reshape(nb, n_frames, cpf), (0, 2, 1))
            data = r.reshape(nb * cpf, n_frames)[safe]   # (len*k, F)
            car = jnp.where(neg, o.astype(jnp.float32)[:, None]
                            * jnp.float32(o_scale / 32000.0), data)
            car = car.reshape(p.len_frame, p.k_total, n_frames)
            return jnp.transpose(car, (2, 0, 1))  # (F, len, k)

        ovl = ship["overlay"]
        carc = jax.lax.complex(
            plane(ship["stream"][:, 0], s_scale / 32000.0, ovl[..., 0]
                  .reshape(-1)),
            plane(ship["stream"][:, 1], s_scale / 32000.0, ovl[..., 1]
                  .reshape(-1)))
        shifted = jnp.pad(carc, ((0, 0), (0, 0),
                                 (p.left_nulls, p.fft_size - p.k_total
                                  - p.left_nulls)))
        spec = jnp.roll(shifted, -(p.fft_size // 2), axis=2)
        sym = jnp.fft.ifft(spec, axis=2) \
            * jnp.float32(p.fft_size / np.sqrt(p.k_total))
        g = p.guard_size
        with_gi = jnp.concatenate([sym[:, :, -g:], sym], axis=2
                                  ).reshape(n_frames, body_len)
        p1c = jax.lax.complex(ship["p1"][..., 0].astype(jnp.float32),
                              ship["p1"][..., 1].astype(jnp.float32)) \
            * jnp.float32(p_scale / 32000.0)
        return jnp.concatenate(
            [jnp.broadcast_to(p1c[None], (n_frames, 2048)), with_gi],
            axis=1)                               # (F, frame_samples)

    return synth, ship
