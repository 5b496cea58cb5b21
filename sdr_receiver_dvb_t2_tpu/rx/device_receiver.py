"""DeviceT2Receiver: the high-level receiver running its bulk path on the
accelerator (fused carrier-major demod + separable LLR + QC-layered LDPC),
with acquisition, L1 parsing and TS reassembly on host.

Same auto-discovery contract as rx.receiver.T2Receiver; the device path is
keyed by (mode, PLP, num_blocks) and compiled once per configuration.  One
early-exit layered LDPC decoder (ops.ldpc_pallas.make_decoder) serves every
batch size.

Host tail (VERDICT r1 item 8): the BCH gate is ONE batched GEMM against the
remainder matrix (ops.fec_device.bch_check_host) over all codewords;
Berlekamp-Massey/Chien runs only on the rare dirty codeword.  Descramble +
byte packing are vectorized and the TS assembler consumes bytes
(TSAssembler.push_bytes), so no per-bit Python survives at rate.
"""
from __future__ import annotations

import numpy as np

from ..dvbt2 import bbframe
from ..dvbt2.params import PLPParams, T2Params
from ..ops import fec_device
from . import decode as rxdecode
from . import fusedpath
from .receiver import T2Receiver


class DeviceT2Receiver(T2Receiver):
    def __init__(self, plp_filter: int | None = None,
                 ldpc_max_iters: int = 24, stream_batch: int = 4, profile: str = "base",
                 fs: float | None = None):
        from ..dvbt2.params import SAMPLE_RATE
        super().__init__(plp_filter=plp_filter, profile=profile,
                         fs=SAMPLE_RATE if fs is None else fs)
        self.ldpc_max_iters = ldpc_max_iters
        # streaming: correct samples on device too (ops/frontend_device,
        # the stages the bench measures); StreamingReceiver falls back to
        # the host chain when the device rate is outside the chain's bound
        self.wants_device_frontend = True
        # F-frame superstep size for the streaming loop (the bench's F=96
        # shape scaled to test captures); the streaming receiver calls
        # decode_frames_batch whenever this many tracked frames are pending
        self.stream_batch = stream_batch
        self.batch_supersteps = 0
        self._paths: dict = {}
        self._mf_paths: dict = {}
        self._decoders: dict = {}
        self._nvar: float | None = None

    def _get_path(self, params: T2Params, plp: PLPParams, num_blocks: int,
                  l1_cells: int, start_cell: int, sub_slices: int = 1,
                  slice_interval: int = 0):
        key = (params, plp, num_blocks, l1_cells, start_cell,
               sub_slices, slice_interval)
        if key not in self._paths:
            demod = fusedpath.get_fused_demod(params)
            self._paths[key] = fusedpath.FusedPLPPath(
                params, plp, num_blocks, demod,
                plp_start_cell=start_cell, l1_cells=l1_cells,
                sub_slices=sub_slices, slice_interval=slice_interval)
        return self._paths[key]

    @staticmethod
    def _slicing(plp: PLPParams, l1post):
        """(sub_slices, slice_interval) of a PLP under the decoded dynamic
        (type-2 round-robin slice switching, clause 8.3.6.3)."""
        ss = plp.sub_slices if plp.plp_type == 2 else 1
        iv = l1post.dyn.sub_slice_interval if ss > 1 else 0
        return ss, iv

    def _decode_ldpc(self, plp: PLPParams, llrs_t, pstat) -> np.ndarray:
        """(N, B) LLRs -> (B, N) hard bits through the early-exit layered
        decoder (the reference's TRIALS + bad() semantics,
        ldpc_decoder.h:62, layered_decoder.hh:65-82; reversed layer order,
        ~0.4 sweeps faster than natural at threshold).  Any batch size;
        records the sweep count."""
        from ..ops import ldpc_pallas as qldpc
        key = (plp.fec_frame, plp.rate)
        if key not in self._decoders:
            self._decoders[key] = qldpc.make_decoder(
                plp.fec_frame, plp.rate, max_iters=self.ldpc_max_iters)
        bits_t, sweeps = self._decoders[key](llrs_t)
        pstat.ldpc_iters.append(int(sweeps))
        return np.asarray(bits_t).T

    def _get_mf_path(self, params, specs, n_frames, l1_cells):
        """specs: tuple of (plp, num_blocks, start_cell, sub_slices,
        slice_interval) — ALL PLPs decoded by one superstep."""
        key = (params, specs, n_frames, l1_cells)
        if key not in self._mf_paths:
            import jax.numpy as jnp
            self._mf_paths[key] = fusedpath.MultiFramePath(
                params, n_frames=n_frames, llr_dtype=jnp.bfloat16,
                emit_l1=True, emit_evm=True, l1_cells=l1_cells,
                plp_specs=list(specs))
        return self._mf_paths[key]

    def _track_inband(self, plp, frames_bytes, pstat, dyn) -> None:
        """In-band type-A (clause 5.2.3): parse the payload from the
        Interleaving Frame's first BB frame and cross-check the PREVIOUS
        frame's signalled scheduling against the decoded L1 dynamic."""
        if not plp.in_band_a:
            return
        if not len(frames_bytes):
            # no payload recovered this frame: clear the entry — a later
            # frame must not be coherence-checked (or L1-loss-patched)
            # against an OLDER frame's next-frame schedule
            self._inband_prev[dyn.id] = None
            return
        from ..dvbt2 import inband
        ib_prev = self._inband_prev.get(dyn.id)
        if ib_prev is not None and (
                ib_prev.current_plp_start != dyn.start
                or ib_prev.current_plp_num_blocks != dyn.num_blocks):
            pstat.inband_mismatches += 1
        ib = inband.extract_from_bb_bytes(frames_bytes[0])
        self._inband_prev[dyn.id] = ib
        if ib is not None:
            pstat.inband.append(ib)

    def decode_frames_batch(self, x, frame_starts, params, plps, l1pre,
                            assembler, stats) -> int:
        """Decode len(frame_starts) frames in ONE MultiFramePath superstep
        (the F-frame batched pipeline bench.py measures, wired into the
        streaming loop).  Assumes the last seen L1-dynamic (constant
        scheduling steady state) for ALL active PLPs — multi-PLP frames,
        including type-2 sub-sliced ones, decode in the same superstep
        (the reference's slice switching at rate,
        time_deinterleaver.cpp:354-366); each frame's actual L1 is parsed
        from the superstep's emitted L1 cells and any frame whose dynamic
        differs is re-decoded through the per-frame path.  Returns frames
        decoded.

        The noise variance driving the LLR scale comes from the PREVIOUS
        superstep's device-computed EVM (emit_evm) — the streaming analogue
        of the reference's per-block SNR update (llr_demapper.cpp:184-196).
        """
        import jax.numpy as jnp
        from . import p1_detect as rxp1
        from ..dvbt2 import l1 as l1mod

        n = len(frame_starts)
        l1post = self._last_l1post
        self.last_batch_failures = 0
        if (l1post is None or self._nvar is None
                or len(l1post.dyn.plp) != len(plps)):
            return 0   # steady state not established: per-frame path
        active = []    # (plp, dyn, sub_slices, slice_interval)
        for plp, dyn in zip(plps, l1post.dyn.plp):
            if (self.plp_filter is not None and dyn.id != self.plp_filter) \
                    or dyn.num_blocks == 0:
                continue
            ss, iv = self._slicing(plp, l1post)
            active.append((plp, dyn, ss, iv))
        if not active:
            return 0
        l1_size = l1mod.L1_PRE_CELLS + l1pre.l1_post_size
        specs = tuple((plp, dyn.num_blocks, dyn.start, ss, iv)
                      for plp, dyn, ss, iv in active)
        mf = self._get_mf_path(params, specs, n, l1_size)
        blen = params.len_frame * params.symbol_size
        bodies = np.empty((n, blen, 2), np.float32)
        for i, fs in enumerate(frame_starts):
            b = x[fs + rxp1.P1_LEN:fs + rxp1.P1_LEN + blen]
            bodies[i, :, 0] = np.real(b)
            bodies[i, :, 1] = np.imag(b)
        inv = jnp.float32(1.0 / max(self._nvar, 1e-4))
        llrs, l1c, evm = mf._fn(jnp.asarray(bodies), inv)
        if not mf.multi:
            llrs = (llrs,)
        l1c = np.asarray(l1c)
        evm = np.asarray(evm)
        self._nvar = float(np.mean(evm))
        # (F, N, nb) per PLP so per-frame slices are leading-axis reads
        lfs = [jnp.transpose(ll, (2, 0, 1)) for ll in llrs]

        def dyn_matches(l1p_i):
            if len(l1p_i.dyn.plp) != len(l1post.dyn.plp):
                return False
            if l1p_i.dyn.sub_slice_interval != l1post.dyn.sub_slice_interval:
                return False
            return all(di.id == dj.id and di.start == dj.start
                       and di.num_blocks == dj.num_blocks
                       for di, dj in zip(l1p_i.dyn.plp, l1post.dyn.plp))

        for i in range(n):
            head = l1c[l1mod.L1_PRE_CELLS:l1_size, i, 0] \
                + 1j * l1c[l1mod.L1_PRE_CELLS:l1_size, i, 1]
            stats.last_cells = head[:1024]
            stats.last_cells_label = "L1-post cells (eq, device)"
            l1p_i = l1mod.l1post_decode_hard(head, l1pre)
            if l1p_i is None or not dyn_matches(l1p_i):
                # scheduling changed (or L1 corrupt): exact per-frame path
                ok = self._decode_frame(x, frame_starts[i], params, plps,
                                        l1pre, None, assembler, stats)
                if not ok:
                    # re-running the identical decode cannot succeed; mark
                    # the frame failed and let the caller's fail streak see
                    # it via last_batch_failures
                    self.last_batch_failures += 1
                continue
            self._last_l1post = l1p_i
            for (plp, dyn, _, _), lf in zip(active, lfs):
                pstat = stats.plp_stats.setdefault(
                    dyn.id, rxdecode.PLPDecodeStats())
                bits = self._decode_ldpc(plp, lf[i], pstat)
                fec = plp.fec
                bb = fec_device.bch_correct_batch(plp, bits[:, :fec.n_bch],
                                                  pstat)
                frames_bytes = np.packbits(bbframe.scramble(bb), axis=1)
                # per-PLP framing state: each PLP is its own TS byte stream
                assembler.stream(dyn.id if len(plps) > 1 else None
                                 ).push_frames(frames_bytes)
                self._track_inband(plp, frames_bytes, pstat, dyn)
            for plp, dyn in zip(plps, l1post.dyn.plp):
                # PLPs skipped this frame (filtered / zero blocks): clear
                # their in-band entries so a later frame is never checked
                # against an older frame's next-frame schedule
                if plp.in_band_a and not any(
                        d is dyn for _, d, _, _ in active):
                    self._inband_prev[dyn.id] = None
            stats.snr_db.append(float(-10.0 * np.log10(
                max(float(evm[i]), 1e-12))))
            stats.timing_offset.append(0.0)
            stats.frames_decoded += 1
        self.batch_supersteps += 1
        return n

    def _decode_frame(self, x, frame_start, params, plps, l1pre,
                      l1post_cached, assembler, stats) -> bool:
        import jax.numpy as jnp
        from . import p1_detect as rxp1
        from ..dvbt2 import l1 as l1mod

        body = x[frame_start + rxp1.P1_LEN:
                 frame_start + rxp1.P1_LEN
                 + params.len_frame * params.symbol_size]
        demod = fusedpath.get_fused_demod(params)
        body2 = np.stack([np.real(body), np.imag(body)], -1
                         ).astype(np.float32)
        flat2 = demod._fn(jnp.asarray(body2))

        # L1 parse on host from the class-layout cells
        l1_size = l1mod.L1_PRE_CELLS + l1pre.l1_post_size
        head2 = np.asarray(flat2[demod.layout[:l1_size]])
        head = head2[:, 0] + 1j * head2[:, 1]
        stats.last_cells = head[l1mod.L1_PRE_CELLS:l1_size][:1024]
        stats.last_cells_label = "L1-post cells (eq, device)"
        # per-frame timing from the frame's own P1 (whole-sample grid
        # drift, feeds the SCO retiming in receive()'s frame loop)
        m = rxp1.measure_p1(np.asarray(x), frame_start, fs=self.fs)
        stats.timing_offset.append(float(m.offset) if m is not None else 0.0)
        snr_seen = None
        if l1post_cached is not None:
            l1post = l1post_cached
        else:
            l1post = l1mod.l1post_decode_hard(
                head[l1mod.L1_PRE_CELLS:l1_size], l1pre)
            if l1post is None:
                # soft fallback using the L1 LDPC parity the reference
                # discards; nvar from the L1 cells' own EVM
                nvar_l1 = rxdecode.estimate_noise_var_l1(
                    head[l1mod.L1_PRE_CELLS:l1_size], l1pre)
                l1post = l1mod.l1post_decode_soft(
                    head[l1mod.L1_PRE_CELLS:l1_size], l1pre, nvar=nvar_l1)
            if l1post is None:
                stats.l1_failures += 1
                l1post = self._last_l1post
                if l1post is None:
                    stats.snr_db.append(0.0)
                    return False
                if l1post.dyn_next is not None:
                    import dataclasses as _dc
                    l1post = _dc.replace(l1post, dyn=l1post.dyn_next)
                else:
                    # in-band type-A scheduling fallback (clause 5.2.3)
                    l1post = self._inband_patched(l1post)
            else:
                self._last_l1post = l1post

        for plp, dyn in zip(plps, l1post.dyn.plp):
            if (self.plp_filter is not None and dyn.id != self.plp_filter) \
                    or dyn.num_blocks == 0:
                # skipped this frame: its in-band schedule (if any) was
                # never recovered, so clear the stale entry
                if plp.in_band_a:
                    self._inband_prev[dyn.id] = None
                continue
            pstat = stats.plp_stats.setdefault(
                dyn.id, rxdecode.PLPDecodeStats())
            ss, iv = self._slicing(plp, l1post)
            path = self._get_path(params, plp, dyn.num_blocks,
                                  l1_size, dyn.start, ss, iv)
            # noise estimate from the L1 cells' EVM (unrotated, no cyclic
            # Q-delay — the PLP cells here are still interleaved, so a
            # constellation EVM on them would mispair I/Q)
            nvar = rxdecode.estimate_noise_var_l1(
                head[:l1mod.L1_PRE_CELLS], l1pre_bpsk=True)
            self._nvar = nvar      # seeds the batched superstep's LLR scale
            if snr_seen is None:
                # constellation power is normalized to 1, so the EVM-based
                # noise estimate IS the inverse SNR (the reference's blind
                # estimate, llr_demapper.cpp:184-196)
                snr_seen = -10.0 * np.log10(max(nvar, 1e-12))
            llrs_t = path._fn(flat2, jnp.float32(1.0 / max(nvar, 1e-4)))
            bits = self._decode_ldpc(plp, llrs_t, pstat)
            fec = plp.fec
            bb = fec_device.bch_correct_batch(plp, bits[:, :fec.n_bch],
                                              pstat)
            frames_bytes = np.packbits(bbframe.scramble(bb), axis=1)
            assembler.stream(dyn.id if len(plps) > 1 else None
                             ).push_frames(frames_bytes)
            self._track_inband(plp, frames_bytes, pstat, dyn)
        stats.snr_db.append(float(snr_seen) if snr_seen is not None
                            else 30.0)
        stats.frames_decoded += 1
        return True
