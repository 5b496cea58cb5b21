"""Fused device receive path equivalence vs the NumPy oracle."""
import numpy as np
import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.dvbt2 import l1 as l1mod
from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as ldpcmod
from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu.ops import ldpc as jldpc
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qldpc
from sdr_receiver_dvb_t2_tpu.rx import decode as npdec
from sdr_receiver_dvb_t2_tpu.rx import demod as npd
from sdr_receiver_dvb_t2_tpu.rx import fusedpath as fp
from sdr_receiver_dvb_t2_tpu.tx.modulator import T2Modulator

RNG = np.random.default_rng(11)


def _setup():
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=3,
                    time_il_length=1)
    mod = T2Modulator(p, [plp])
    ts = RNG.integers(0, 256, (mod.packets_needed(1) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    out = mod.modulate(ts.reshape(-1), 1)
    return p, plp, out


def test_fused_demod_matches_oracle():
    p, plp, out = _setup()
    carriers = npd.extract_carriers(p, out.samples, 2048)
    oracle = npd.equalize_frame(p, carriers).frame_cells
    fd = fp.FusedFrameDemod(p)
    body2 = np.stack([np.real(out.samples[2048:]),
                      np.imag(out.samples[2048:])], -1).astype(np.float32)
    flat2 = np.asarray(fd._fn(jnp.asarray(body2)))
    flat = flat2[:, 0] + 1j * flat2[:, 1]
    np.testing.assert_allclose(flat[fd.layout], oracle, atol=1e-3)
    # layout is a permutation covering every cell
    assert np.array_equal(np.sort(fd.layout), np.arange(fd.total_cells))


def test_fused_plp_path_and_nb_decoder():
    p, plp, out = _setup()
    fd = fp.FusedFrameDemod(p)
    body2 = np.stack([np.real(out.samples[2048:]),
                      np.imag(out.samples[2048:])], -1).astype(np.float32)
    flat2 = jnp.asarray(fd._fn(jnp.asarray(body2)))
    path = fp.FusedPLPPath(p, plp, 3, fd)
    llr_t = np.asarray(path._fn(flat2, jnp.float32(1e3)))
    # against the NumPy oracle
    carriers = npd.extract_carriers(p, out.samples, 2048)
    oracle = npd.equalize_frame(p, carriers).frame_cells
    l1c = l1mod.L1_PRE_CELLS + out.l1pre.l1_post_size
    sl = oracle[l1c:l1c + 3 * plp.cells_per_fec_block]
    cells2 = npdec.deinterleave_plp_frame(plp, sl, 3)
    llr_np = npdec.bits_from_llrs(plp, npdec.llr_demap(plp, cells2, 1e-3))
    assert ((llr_t.T < 0) == (llr_np < 0)).all()
    # nb-layout decoder closes the loop
    dec = qldpc.make_xla_decoder(plp.fec_frame, plp.rate, max_iters=8)
    bits_t = np.asarray(dec(jnp.asarray(llr_t))[0])
    code = ldpcmod.get_code(plp.fec_frame, plp.rate)
    assert jldpc.syndrome_ok(code, bits_t.T).all()


def test_multiframe_path_matches_single():
    p, plp, _ = _setup()
    mod = T2Modulator(p, [plp])
    ts = RNG.integers(0, 256, (mod.packets_needed(2) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    out = mod.modulate(ts.reshape(-1), 2)
    bodies = []
    for fi in range(2):
        s0 = fi * p.frame_samples + 2048
        b = out.samples[s0:s0 + p.len_frame * p.symbol_size]
        bodies.append(np.stack([np.real(b), np.imag(b)], -1
                               ).astype(np.float32))
    mf = fp.MultiFramePath(p, plp, 3, 2)
    llrs = np.asarray(mf(jnp.asarray(np.stack(bodies)), jnp.float32(1e3)))
    fd = fp.get_fused_demod(p)
    single = fp.get_fused_plp_path(p, plp, 3)
    for fi in range(2):
        flat2 = fd._fn(jnp.asarray(bodies[fi]))
        ref = np.asarray(single._fn(flat2, jnp.float32(1e3)))
        assert ((llrs[:, :, fi] < 0) == (ref < 0)).all()


def test_device_receiver_end_to_end():
    from sdr_receiver_dvb_t2_tpu.rx.device_receiver import DeviceT2Receiver
    p, plp, out = _setup()
    res = DeviceT2Receiver().receive(out.samples)
    assert res.stats.frames_decoded == 1
    assert len(res.ts) > 0


def test_fused_demod_1k_multi_p2_and_fc():
    """1K FFT: 16 P2 symbols (even/odd classes) + frame-closing symbol."""
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import (FFTMode, GuardInterval,
                                                      PilotPattern)
    p = T2Params(fft_mode=FFTMode.FFT_1K, guard=GuardInterval.GI_1_16,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=20)
    assert p.n_p2 == 16 and p.has_fc
    plp = PLPParams(constellation=Constellation.QPSK, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, rotated=False,
                    num_blocks_max=2, time_il_length=1)
    mod = T2Modulator(p, [plp])
    ts = RNG.integers(0, 256, (mod.packets_needed(1) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    out = mod.modulate(ts.reshape(-1), 1)
    carriers = npd.extract_carriers(p, out.samples, 2048)
    oracle = npd.equalize_frame(p, carriers).frame_cells
    fd = fp.FusedFrameDemod(p)
    body = out.samples[2048:2048 + p.len_frame * p.symbol_size]
    body2 = np.stack([np.real(body), np.imag(body)], -1).astype(np.float32)
    flat2 = np.asarray(fd._fn(jnp.asarray(body2)))
    flat = flat2[:, 0] + 1j * flat2[:, 1]
    np.testing.assert_allclose(flat[fd.layout], oracle, atol=1e-3)


def test_multiframe_emit_l1_and_evm():
    """emit_l1/emit_evm variants: LLRs unchanged, L1 cells match the
    single-frame demod layout head, EVM tracks the injected noise power."""
    p, plp, out = _setup()
    rng = np.random.default_rng(3)
    nv = 10.0 ** (-25 / 10.0)  # 25 dB AWGN
    y = out.samples + (rng.normal(0, np.sqrt(nv / 2), len(out.samples))
                       + 1j * rng.normal(0, np.sqrt(nv / 2),
                                         len(out.samples)))
    body = y[2048:2048 + p.len_frame * p.symbol_size]
    body2 = np.stack([np.real(body), np.imag(body)], -1).astype(np.float32)
    bodies = jnp.asarray(body2[None])
    base = fp.MultiFramePath(p, plp, 3, 1)
    mf = fp.MultiFramePath(p, plp, 3, 1, emit_l1=True, emit_evm=True)
    llrs0 = np.asarray(base(bodies, jnp.float32(100.0)))
    llrs, l1c, evm = mf(bodies, jnp.float32(100.0))
    np.testing.assert_allclose(np.asarray(llrs), llrs0, rtol=1e-5)
    # L1 region equals the single-frame fused demod head
    fd = fp.get_fused_demod(p)
    flat2 = np.asarray(fd._fn(jnp.asarray(body2)))
    head = flat2[fd.layout[:mf.l1_size]]
    got = np.asarray(l1c)[:, 0, :]
    np.testing.assert_allclose(got, head, atol=1e-4)
    # EVM ~ noise variance scaled by the cell normalization (~1): within 3x
    ev = float(np.asarray(evm)[0])
    assert nv / 3 < ev < nv * 3


def test_multiframe_bf16_demod_matches_f32_signs():
    """bf16 demod (half the memory traffic): LLR signs
    must agree with the f32 path at operating SNR — quantization sits at
    ~-40 dB EVM, far below the FEC margin."""
    p, plp, out = _setup()
    rng = np.random.default_rng(2)
    nv = 10.0 ** (-20 / 10)
    y = out.samples + (rng.normal(0, np.sqrt(nv / 2), len(out.samples))
                       + 1j * rng.normal(0, np.sqrt(nv / 2),
                                         len(out.samples)))
    body = y[2048:2048 + p.len_frame * p.symbol_size]
    b2 = np.stack([np.real(body), np.imag(body)], -1).astype(np.float32)
    bodies = jnp.asarray(b2[None])
    llr0 = np.asarray(fp.MultiFramePath(p, plp, 3, 1)(
        bodies, jnp.float32(100.0)))
    b16 = fp.MultiFramePath(p, plp, 3, 1, llr_dtype=jnp.bfloat16,
                            demod_dtype=jnp.bfloat16)
    llr1 = np.asarray(b16(bodies.astype(jnp.bfloat16), jnp.float32(100.0))
                      ).astype(np.float32)
    flips = ((llr0 < 0) != (llr1 < 0))
    assert flips.mean() < 1e-3
    if flips.any():
        # flips only at near-zero LLRs (ambiguous bits)
        assert np.abs(llr0[flips]).max() < 0.05 * np.abs(llr0).max()


def test_syms_entry_class_ordered_matches_planes():
    """The syms entry consumes CLASS-ORDERED GI-stripped symbols (the
    fused front end emits them in demod.sym_order for free — its
    per-symbol scan reads the grid permuted); LLRs must equal the
    natural-order planes entry exactly."""
    p, plp, _ = _setup()
    mod = T2Modulator(p, [plp])
    ts = RNG.integers(0, 256, (mod.packets_needed(2) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    out = mod.modulate(ts.reshape(-1), 2)
    bodies = []
    for fi in range(2):
        s0 = fi * p.frame_samples + 2048
        b = out.samples[s0:s0 + p.len_frame * p.symbol_size]
        bodies.append(np.stack([np.real(b), np.imag(b)], -1
                               ).astype(np.float32))
    bod = np.stack(bodies)
    mf = fp.MultiFramePath(p, plp, 3, 2)
    ref = np.asarray(mf._fn_planes(jnp.asarray(bod[..., 0]),
                                   jnp.asarray(bod[..., 1]),
                                   jnp.float32(1e3)))
    syms = bod.reshape(2, p.len_frame, p.symbol_size, 2)[:, :,
                                                         p.guard_size:, :]
    so = mf.demod.sym_order
    assert np.array_equal(np.sort(so), np.arange(p.len_frame))
    ordered = syms[:, so]
    got = np.asarray(mf._fn_syms(jnp.asarray(ordered[..., 0]),
                                 jnp.asarray(ordered[..., 1]),
                                 jnp.float32(1e3)))
    np.testing.assert_array_equal(got, ref)
