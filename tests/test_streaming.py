"""Round-2 streaming pipeline tests: persistent lock across block
boundaries (zero frame loss), closed AGC loop, drifting-LO CFO tracking,
streaming SCO correction, checkpoint/resume TS continuity, and the native
ring ingest path.

Reference behaviors matched: the always-running device loop with elastic
buffering (rx_sdrplay.cpp:199-291), the AGC level loop
(dvbt2_demodulator.cpp:234-249), the frequency PI loop
(dvbt2_demodulator.cpp:321-330), and the reset/reacquire state machine
(dvbt2_demodulator.cpp:418-425)."""
import numpy as np
import pytest

from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu.io import devices
from sdr_receiver_dvb_t2_tpu.tx.modulator import T2Modulator


def _waveform(n_frames=6, seed=5):
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=3,
                    time_il_length=1)
    mod = T2Modulator(p, [plp])
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, (mod.packets_needed(n_frames) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    out = mod.modulate(ts.reshape(-1), n_frames)
    return ts.reshape(-1), out.samples, p


def _stream(dev, **kw):
    got = []
    kw.setdefault("acq_seconds", 0.025)
    kw.setdefault("block_seconds", 0.007)
    sr = devices.StreamingReceiver(dev, **kw)
    st = sr.run(ts_sink=got.append)
    ts = np.concatenate(got) if got else np.zeros(0, np.uint8)
    return st, ts


def test_stream_no_block_boundary_loss():
    """Frames straddling block boundaries decode: the lock (frame grid,
    CFO, L1) and leftover samples persist across blocks."""
    flat, samples, p = _waveform(6)
    n_blocks_expected = len(samples) / (devices.SAMPLE_RATE * 0.007)
    assert n_blocks_expected > 5  # boundaries fall inside frames
    dev = devices.SimulatedDevice(samples, snr_db=32)
    st, ts = _stream(dev)
    assert st.frames_decoded == 6
    assert st.frames_skipped == 0
    assert st.reacquisitions == 0
    assert st.ts_errors == 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])
    assert len(ts) >= 30 * 188


def test_stream_agc_converges_from_cold():
    """-40 dB input behind an 8-bit ADC is buried in quantization noise;
    the AGC loop must step hardware gain up and the receiver then lock and
    decode, with no manual steps (VERDICT item 5)."""
    flat, samples, p = _waveform(8)
    dev = devices.SimulatedDevice(samples, gain_db=-40.0, snr_db=28,
                                  adc_bits=8)
    st, ts = _stream(dev, block_seconds=0.005)
    assert st.gain_steps >= 3
    assert abs(st.level_db) < 4.0          # converged to target
    assert st.frames_decoded >= 3
    # decoded TS must be a contiguous slice of the transmitted stream
    assert len(ts) >= 10 * 188
    pos = bytes(flat).find(bytes(ts[:4 * 188]))
    assert pos >= 0 and pos % 188 == 0
    np.testing.assert_array_equal(ts, flat[pos:pos + len(ts)])


def test_stream_agc_converges_from_hot():
    """+24 dB input clips the ADC; AGC steps gain down until decodable."""
    flat, samples, p = _waveform(8)
    dev = devices.SimulatedDevice(samples, gain_db=24.0, snr_db=28,
                                  adc_bits=8)
    st, ts = _stream(dev, block_seconds=0.005)
    assert st.gain_steps >= 2
    assert st.frames_decoded >= 3
    assert len(ts) >= 10 * 188
    pos = bytes(flat).find(bytes(ts[:4 * 188]))
    assert pos >= 0 and pos % 188 == 0
    np.testing.assert_array_equal(ts, flat[pos:pos + len(ts)])


def test_stream_agc_required():
    """Sanity: without AGC the cold capture must NOT decode (otherwise the
    convergence test proves nothing)."""
    flat, samples, p = _waveform(4)
    dev = devices.SimulatedDevice(samples, gain_db=-40.0, snr_db=28,
                                  adc_bits=8)
    st, ts = _stream(dev, block_seconds=0.005, agc=False)
    assert st.frames_decoded == 0


def test_stream_drifting_lo_tracked():
    """A linearly drifting LO (0 -> ~500 Hz across the capture, more than
    half the 8K carrier spacing) is tracked by the per-frame P1 frequency
    PI loop; all frames stay bit-exact (VERDICT item 6)."""
    flat, samples, p = _waveform(8)
    dur = len(samples) / devices.SAMPLE_RATE
    drift = 500.0 / dur
    dev = devices.SimulatedDevice(samples, lo_drift_hz_per_s=drift,
                                  snr_db=30)
    st, ts = _stream(dev)
    assert st.frames_decoded == 8
    assert st.frames_skipped == 0
    assert st.ts_errors == 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])
    # the corrector should have accumulated a large fraction of the drift
    assert st.cfo_hz > 250.0


def test_stream_dc_iq_imbalance_corrected():
    """A receiver front end with a DC offset and 2% Q-branch gain imbalance
    plus quadrature skew at 20 dB SNR decodes bit-exact: the streaming
    chain's DCIQCorrector estimates and removes both continuously, like the
    reference's per-sample DC averager + 1-bit IQ-imbalance loop
    (dvbt2_demodulator.cpp:187-192, 256-265).  The estimator state must
    converge to the injected impairments and surface in StreamStats."""
    flat, samples, p = _waveform(6)
    dev = devices.SimulatedDevice(samples, snr_db=20,
                                  dc_offset=0.08 - 0.05j,
                                  iq_gain=1.02, iq_skew=0.02)
    st, ts = _stream(dev)
    assert st.frames_decoded == 6
    assert st.ts_errors == 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])
    # estimator converged to the injected impairments
    assert abs(st.dc_offset_est - (0.08 - 0.05j)) < 0.01
    assert abs(st.iq_gain_est - 1.02) < 0.01
    assert abs(st.iq_skew_est - 0.02) < 0.01


def test_stream_dc_iq_correction_is_load_bearing():
    """Sanity for the test above: with the DC/IQ stage disabled, a heavy
    imbalance + DC must corrupt the decode (otherwise the corrected run
    proves nothing).  Uses a harsher impairment than the closed-loop test
    since mild ones are partially absorbed by the equalizer."""
    from sdr_receiver_dvb_t2_tpu.rx import frontend

    flat, samples, p = _waveform(4)
    impair = dict(dc_offset=0.5 - 0.3j, iq_gain=1.3, iq_skew=0.25)
    dev = devices.SimulatedDevice(samples, snr_db=20, **impair)

    orig = frontend.CorrectorChain.__init__

    def no_dciq(self, *a, **kw):
        kw["dc_iq"] = False
        orig(self, *a, **kw)

    frontend.CorrectorChain.__init__ = no_dciq
    try:
        st_off, ts_off = _stream(devices.SimulatedDevice(
            samples, snr_db=20, **impair))
    finally:
        frontend.CorrectorChain.__init__ = orig
    st_on, ts_on = _stream(dev)
    ok_off = (st_off.frames_decoded == 4 and st_off.ts_errors == 0
              and np.array_equal(ts_off, flat[:len(ts_off)]))
    assert not ok_off, "uncorrected run decoded clean; impairment too mild"
    assert st_on.frames_decoded == 4 and st_on.ts_errors == 0
    np.testing.assert_array_equal(ts_on, flat[:len(ts_on)])


def test_stream_sco_corrected():
    """A 60 ppm sample-clock offset triggers the streaming resampler
    (CorrectorChain.rebase_ratio); decode stays bit-exact and the measured
    correction lands near the truth."""
    flat, samples, p = _waveform(6)
    dev = devices.SimulatedDevice(samples, clock_ppm=60.0, snr_db=32)
    st, ts = _stream(dev)
    assert st.frames_decoded >= 5
    assert st.ts_errors == 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])
    assert 25.0 < abs(st.sco_ppm) < 100.0


def test_stream_checkpoint_resume(tmp_path):
    """Interrupt a streaming run, resume from its checkpoint with a fresh
    receiver: the concatenated TS equals the uninterrupted run's TS
    (exact continuity, no duplicate or lost packets)."""
    from sdr_receiver_dvb_t2_tpu.utils.checkpoint import StreamCheckpoint
    flat, samples, p = _waveform(8)
    ck_path = str(tmp_path / "stream.ck")

    # uninterrupted reference run
    dev0 = devices.SimulatedDevice(samples, snr_db=32)
    st0, ts_full = _stream(dev0)
    assert st0.frames_decoded == 8

    # interrupted run: stop after 5 blocks, checkpoint every 2 frames
    dev1 = devices.SimulatedDevice(samples, snr_db=32)
    got1 = []
    sr1 = devices.StreamingReceiver(dev1, acq_seconds=0.025,
                                    block_seconds=0.007,
                                    checkpoint_path=ck_path,
                                    checkpoint_every=2)
    st1 = sr1.run(ts_sink=got1.append, max_blocks=5)
    ck = StreamCheckpoint.load(ck_path)
    assert ck.frames_decoded >= 2

    # resume with a brand-new receiver on a fresh device
    dev2 = devices.SimulatedDevice(samples, snr_db=32)
    got2 = []
    sr2 = devices.StreamingReceiver(dev2, acq_seconds=0.025,
                                    block_seconds=0.007)
    st2 = sr2.run(ts_sink=got2.append, resume=ck_path)
    assert st2.frames_decoded >= 1

    ts1 = (np.concatenate(got1) if got1 else np.zeros(0, np.uint8)
           )[:ck.ts_packets * 188]
    ts2 = np.concatenate(got2) if got2 else np.zeros(0, np.uint8)
    joined = np.concatenate([ts1, ts2])
    np.testing.assert_array_equal(joined, ts_full[:len(joined)])
    assert len(joined) >= len(ts_full) - 2 * 188


def test_stream_ring_ingest():
    """The native SPSC ring + reader thread path produces the same TS as
    the direct path (elastic ingest actually wired, VERDICT weak #6)."""
    from sdr_receiver_dvb_t2_tpu import native
    if native.get_lib() is None:
        pytest.skip("native ingest library unavailable")
    flat, samples, p = _waveform(6)
    dev = devices.SimulatedDevice(samples, snr_db=32)
    st, ts = _stream(dev, use_ring=True)
    assert st.frames_decoded == 6
    np.testing.assert_array_equal(ts, flat[:len(ts)])


def test_stream_reacquires_after_corruption():
    """A burst of interference mid-capture breaks tracking; the receiver
    unlocks, re-acquires, and continues decoding (the reference's reset
    path, dvbt2_demodulator.cpp:418-425)."""
    flat, samples, p = _waveform(8)
    x = np.array(samples)
    # obliterate frames 3-4 with noise
    fs0 = p.frame_samples
    rng = np.random.default_rng(9)
    burst = slice(3 * fs0, 5 * fs0)
    n = burst.stop - burst.start
    sig = float(np.sqrt(np.mean(np.abs(x) ** 2)))
    x[burst] = sig * (rng.normal(0, 0.7, n) + 1j * rng.normal(0, 0.7, n)
                      ).astype(np.complex64)
    dev = devices.SimulatedDevice(x, snr_db=30)
    st, ts = _stream(dev, agc=False)
    # frames before and after the burst decode
    assert st.frames_decoded >= 5
    assert st.frames_skipped + st.reacquisitions >= 1
    assert len(ts) >= 15 * 188
    pos = bytes(flat).find(bytes(ts[:2 * 188]))
    assert pos == 0  # stream starts at the first packet


def test_stream_device_receiver_path():
    """The streaming loop with DeviceT2Receiver substituted (the CLI's
    --stream --device-path route): persistent lock + fused demod + batched
    FEC tail, TS bit-exact with zero boundary loss.  After the first
    (nvar-seeding) frames, decoding runs as F-frame MultiFramePath
    supersteps — the bench pipeline inside the streaming loop."""
    from sdr_receiver_dvb_t2_tpu.rx.device_receiver import DeviceT2Receiver
    flat, samples, p = _waveform(8)
    dev = devices.SimulatedDevice(samples, snr_db=32)
    rx = DeviceT2Receiver(stream_batch=3)
    st, ts = _stream(dev, receiver=rx)
    assert st.frames_decoded == 8
    assert st.frames_skipped == 0
    assert rx.batch_supersteps >= 1
    np.testing.assert_array_equal(ts, flat[:len(ts)])


def test_stream_stage_plots(tmp_path):
    """--plots from a streaming run: per-stage views generated from the
    DEVICE demod of a captured frame (reference GUI parity,
    main_window.cpp:393-441)."""
    import os
    pytest.importorskip("matplotlib")
    from sdr_receiver_dvb_t2_tpu.utils import plots as plotmod
    flat, samples, p = _waveform(4)
    dev = devices.SimulatedDevice(samples, snr_db=30)
    got = []
    sr = devices.StreamingReceiver(dev, acq_seconds=0.025,
                                   block_seconds=0.007)
    st = sr.run(ts_sink=got.append, capture_debug=True)
    assert st.debug is not None
    files = plotmod.stage_plots(st.debug, st.snr_db, st.timing,
                                str(tmp_path))
    assert len(files) >= 6
    for f in files:
        assert os.path.getsize(f) > 5000


def test_stream_device_rate_conversion():
    """A 10 Msps capture (the AirSpy front end's rate) streams through the
    CorrectorChain's rate-conversion stage to the 9.142857 Msps elementary
    rate and decodes bit-exact — the reference's filter_decimator/Farrow
    front-end job (rx_airspy.cpp:77-83) inside the streaming loop."""
    from sdr_receiver_dvb_t2_tpu.rx import frontend
    flat, samples, p = _waveform(6)
    # resample the elementary-rate waveform UP to the 10 Msps device rate
    dev_rate = 10.0e6
    up = frontend.sinc_resample(samples, devices.SAMPLE_RATE / dev_rate,
                                taps=32)
    dev = devices.SimulatedDevice(up, snr_db=32, sample_rate=dev_rate)
    st, ts = _stream(dev)
    assert st.frames_decoded >= 5
    assert st.ts_errors == 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])


def test_stream_multi_plp_filter():
    """Multi-PLP streaming with a PLP filter: the streaming loop (which
    parses L1-dynamic per frame) decodes only the selected PLP, bit-exact —
    the reference's need_plp filter (bb_de_header.cpp:139-142) in the
    continuous pipeline."""
    from sdr_receiver_dvb_t2_tpu.rx.receiver import T2Receiver
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plps = [PLPParams(plp_id=0, constellation=Constellation.QAM16,
                      rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                      num_blocks_max=2, time_il_length=1),
            PLPParams(plp_id=1, constellation=Constellation.QPSK,
                      rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                      rotated=False, num_blocks_max=1, time_il_length=1)]
    mod = T2Modulator(p, plps)
    rng = np.random.default_rng(17)
    ts = rng.integers(0, 256, (mod.packets_needed(5) + 6, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    out = mod.modulate(ts.reshape(-1), 5)
    src = {pkt.tobytes() for pkt in ts}
    for pid in (0, 1):
        dev = devices.SimulatedDevice(out.samples, snr_db=32)
        st, got = _stream(dev, receiver=T2Receiver(plp_filter=pid))
        assert st.frames_decoded == 5, pid
        assert st.ts_errors == 0, pid
        assert len(got) >= 5 * 188, pid
        for pkt in got.reshape(-1, 188):
            assert pkt.tobytes() in src


def test_stream_checkpoint_chain_absolute_offsets(tmp_path):
    """A checkpoint written AFTER a resume must record the absolute device
    offset (resume base + progress), so a second resume continues correctly
    (round-2 review finding)."""
    from sdr_receiver_dvb_t2_tpu.utils.checkpoint import StreamCheckpoint
    flat, samples, p = _waveform(10)
    ck = str(tmp_path / "ck.json")

    dev0 = devices.SimulatedDevice(samples, snr_db=32)
    st0, ts_full = _stream(dev0)
    assert st0.frames_decoded == 10

    # run 1: stop early, checkpoint every 2 frames
    dev1 = devices.SimulatedDevice(samples, snr_db=32)
    got = []
    sr1 = devices.StreamingReceiver(dev1, acq_seconds=0.025,
                                    block_seconds=0.007,
                                    checkpoint_path=ck, checkpoint_every=2)
    sr1.run(ts_sink=got.append, max_blocks=4)
    ck1 = StreamCheckpoint.load(ck)
    got = [np.concatenate(got)[:ck1.ts_packets * 188]]

    # run 2: resume AND keep checkpointing, stop early again
    dev2 = devices.SimulatedDevice(samples, snr_db=32)
    got2 = []
    sr2 = devices.StreamingReceiver(dev2, acq_seconds=0.025,
                                    block_seconds=0.007,
                                    checkpoint_path=ck, checkpoint_every=2)
    sr2.run(ts_sink=got2.append, max_blocks=4, resume=ck)
    ck2 = StreamCheckpoint.load(ck)
    assert ck2.sample_offset > ck1.sample_offset  # absolute, not relative
    # ts_packets counts THIS run's emitted packets (each run's assembler
    # starts fresh after restore)
    got.append(np.concatenate(got2)[:ck2.ts_packets * 188])

    # run 3: resume from the run-2 checkpoint to the end
    dev3 = devices.SimulatedDevice(samples, snr_db=32)
    got3 = []
    sr3 = devices.StreamingReceiver(dev3, acq_seconds=0.025,
                                    block_seconds=0.007)
    sr3.run(ts_sink=got3.append, resume=ck)
    got.append(np.concatenate(got3))

    joined = np.concatenate(got)
    np.testing.assert_array_equal(joined, ts_full[:len(joined)])
    assert len(joined) >= len(ts_full) - 2 * 188


def test_stream_checkpoint_resume_sco_device_chain(tmp_path):
    """Checkpoint resume on the DEVICE front-end chain with a nonzero
    saved SCO: the restored correction must actually resample (ADVICE r4
    medium: a bare `ratio *=` on DeviceFrontendChain touched only the
    reporting attribute — process() resamples at _fine_ratio + _post
    stages — so the frame grid drifted ~sco_ppm * frame_samples per frame
    and TS continuity across resume broke)."""
    from sdr_receiver_dvb_t2_tpu.rx.device_receiver import DeviceT2Receiver
    from sdr_receiver_dvb_t2_tpu.utils.checkpoint import StreamCheckpoint
    flat, samples, p = _waveform(8)
    ck_path = str(tmp_path / "dev.ck")

    dev0 = devices.SimulatedDevice(samples, clock_ppm=60.0, snr_db=32)
    st0, ts_full = _stream(dev0, receiver=DeviceT2Receiver(stream_batch=3))
    assert st0.frontend == "DeviceFrontendChain"
    # the +60 ppm clock shortens the capture: the final frame may truncate
    assert st0.frames_decoded >= 7

    dev1 = devices.SimulatedDevice(samples, clock_ppm=60.0, snr_db=32)
    got1 = []
    sr1 = devices.StreamingReceiver(dev1,
                                    receiver=DeviceT2Receiver(stream_batch=3),
                                    acq_seconds=0.025, block_seconds=0.007,
                                    checkpoint_path=ck_path,
                                    checkpoint_every=2)
    sr1.run(ts_sink=got1.append, max_blocks=5)
    ck = StreamCheckpoint.load(ck_path)
    assert ck.frames_decoded >= 2
    assert abs(ck.sco_ppm) > 20.0    # the SCO made it into the checkpoint

    dev2 = devices.SimulatedDevice(samples, clock_ppm=60.0, snr_db=32)
    got2 = []
    sr2 = devices.StreamingReceiver(dev2,
                                    receiver=DeviceT2Receiver(stream_batch=3),
                                    acq_seconds=0.025, block_seconds=0.007)
    st2 = sr2.run(ts_sink=got2.append, resume=ck_path)
    assert st2.frames_decoded >= 1
    ts1 = (np.concatenate(got1) if got1 else np.zeros(0, np.uint8)
           )[:ck.ts_packets * 188]
    ts2 = np.concatenate(got2) if got2 else np.zeros(0, np.uint8)
    joined = np.concatenate([ts1, ts2])
    np.testing.assert_array_equal(joined, ts_full[:len(joined)])
    assert len(joined) >= len(ts_full) - 2 * 188


def test_stream_miso():
    """MISO capture through the streaming loop (persistent lock + per-frame
    tracking + Alamouti combining); exceeds the SISO-only reference."""
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import Preamble
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9, miso=True, preamble=Preamble.T2_MISO)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, rotated=True,
                    num_blocks_max=3, time_il_length=1)
    mod = T2Modulator(p, [plp])
    rng = np.random.default_rng(19)
    ts = rng.integers(0, 256, (mod.packets_needed(5) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    out = mod.modulate(ts.reshape(-1), 5)

    def ch(x, taps):
        return np.convolve(x, taps)[:len(x)].astype(np.complex64)

    y = (ch(out.samples, [1.0, 0.08j])
         + ch(out.samples2, [0.0, 0.0, 0.6 * np.exp(0.7j), -0.05]))
    dev = devices.SimulatedDevice(y, snr_db=30)
    st, got = _stream(dev)
    assert st.frames_decoded == 5
    assert st.ts_errors == 0
    flat = ts.reshape(-1)
    np.testing.assert_array_equal(got, flat[:len(got)])


def _multi_plp_waveform(n_frames=6, seed=11, type2=False):
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    if type2:
        plps = [PLPParams(plp_id=0, constellation=Constellation.QAM16,
                          rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                          num_blocks_max=1, time_il_length=1),
                PLPParams(plp_id=1, constellation=Constellation.QPSK,
                          rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                          rotated=False, num_blocks_max=1, time_il_length=1,
                          plp_type=2, sub_slices=3),
                PLPParams(plp_id=2, constellation=Constellation.QPSK,
                          rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                          rotated=False, num_blocks_max=2, time_il_length=1,
                          plp_type=2, sub_slices=3)]
    else:
        plps = [PLPParams(plp_id=0, constellation=Constellation.QAM16,
                          rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                          num_blocks_max=2, time_il_length=1),
                PLPParams(plp_id=1, constellation=Constellation.QPSK,
                          rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                          rotated=False, num_blocks_max=1, time_il_length=1)]
    mod = T2Modulator(p, plps)
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, (mod.packets_needed(n_frames) + 6, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    out = mod.modulate(ts.reshape(-1), n_frames)
    return ts, out.samples, p


def test_stream_device_multi_plp_supersteps():
    """Multi-PLP streaming on the DEVICE path with NO filter: the F-frame
    MultiFramePath superstep decodes ALL PLPs of the batch from the ONE
    shared demod (VERDICT r2 item 6; the reference's multi-PLP slice
    switching at rate, time_deinterleaver.cpp:354-366)."""
    from sdr_receiver_dvb_t2_tpu.rx.device_receiver import DeviceT2Receiver
    ts, samples, p = _multi_plp_waveform(8)
    src = {pkt.tobytes() for pkt in ts}
    dev = devices.SimulatedDevice(samples, snr_db=32)
    rx = DeviceT2Receiver(stream_batch=3)
    st, got = _stream(dev, receiver=rx)
    assert st.frames_decoded == 8
    assert rx.batch_supersteps >= 1
    assert st.ts_errors == 0
    assert len(got) >= 8 * 188
    for pkt in got.reshape(-1, 188):
        assert pkt.tobytes() in src


def test_stream_device_type2_superstep_per_plp_bit_exact():
    """Type-2 sub-sliced PLPs stream through the device superstep path
    with a PLP filter: per-PLP TS bit-exact AND batched (batch_supersteps
    > 0) — the round-robin sub-slice gather lives INSIDE the fused
    composed permutation."""
    from sdr_receiver_dvb_t2_tpu.rx.device_receiver import DeviceT2Receiver
    ts, samples, p = _multi_plp_waveform(8, type2=True)
    src = {pkt.tobytes() for pkt in ts}
    for pid in (0, 2):
        dev = devices.SimulatedDevice(samples, snr_db=32)
        rx = DeviceT2Receiver(plp_filter=pid, stream_batch=3)
        st, got = _stream(dev, receiver=rx)
        assert st.frames_decoded == 8, pid
        assert rx.batch_supersteps >= 1, pid
        assert st.ts_errors == 0, pid
        assert len(got) >= 188, pid
        for pkt in got.reshape(-1, 188):
            assert pkt.tobytes() in src


def test_stream_device_frontend_chain():
    """`--device-path` streaming now corrects samples with the DEVICE
    front-end chain (ops/frontend_device.DeviceFrontendChain — the same
    jitted stages the bench measures) instead of host NumPy: a 9.2 Msps
    capture (the SdrPlay/Pluto rate, +0.625% vs elementary) with CFO,
    DC offset and IQ imbalance decodes TS bit-exact, and the estimates
    the chain surfaced match the injected impairments."""
    from sdr_receiver_dvb_t2_tpu.rx.device_receiver import DeviceT2Receiver
    from sdr_receiver_dvb_t2_tpu.rx import frontend as hostfe
    flat, samples, p = _waveform(8)
    # a true 9.2 Msps capture (SimulatedDevice only declares its rate)
    dev_samples = hostfe.sinc_resample(samples, devices.SAMPLE_RATE / 9.2e6)
    dev = devices.SimulatedDevice(dev_samples, snr_db=32,
                                  sample_rate=9.2e6,
                                  lo_offset_hz=700.0,
                                  dc_offset=0.012 - 0.008j,
                                  iq_gain=1.02, iq_skew=0.012)
    rx = DeviceT2Receiver(stream_batch=3)
    st, ts = _stream(dev, receiver=rx)
    assert st.frontend == "DeviceFrontendChain"
    assert st.frames_decoded == 8
    assert st.frames_skipped == 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])
    assert abs(st.cfo_hz - 700.0) < 50.0
    # the device-side EMA estimates converged on the injected impairments
    assert abs(st.iq_gain_est - 1.02) < 8e-3
    assert abs(st.iq_skew_est - 0.012) < 8e-3
    assert abs(st.dc_offset_est - (0.012 - 0.008j)) < 5e-3


def test_stream_device_frontend_airspy_rate_polyphase():
    """The 10 Msps AirSpy rate (35/32 of elementary, +9.4%) now runs on
    the DEVICE chain too: the exact-rational polyphase stage converts
    the vendor rate and the drift resampler handles only the ppm-scale
    residual."""
    from sdr_receiver_dvb_t2_tpu.rx.device_receiver import DeviceT2Receiver
    from sdr_receiver_dvb_t2_tpu.rx import frontend as hostfe
    flat, samples, p = _waveform(6)
    dev_samples = hostfe.sinc_resample(samples, devices.SAMPLE_RATE / 10.0e6)
    dev = devices.SimulatedDevice(dev_samples, snr_db=32, sample_rate=10.0e6)
    rx = DeviceT2Receiver(stream_batch=3)
    st, ts = _stream(dev, receiver=rx)
    assert st.frontend == "DeviceFrontendChain"
    assert st.frames_decoded >= 5
    np.testing.assert_array_equal(ts, flat[:len(ts)])


def test_stream_device_frontend_falls_back_for_odd_ratio():
    """A rate that is neither near-unity nor a small exact rational of
    the elementary rate (9.7 Msps) keeps the host chain."""
    from sdr_receiver_dvb_t2_tpu.rx.device_receiver import DeviceT2Receiver
    from sdr_receiver_dvb_t2_tpu.rx import frontend as hostfe
    flat, samples, p = _waveform(6)
    dev_samples = hostfe.sinc_resample(samples, devices.SAMPLE_RATE / 9.7e6)
    dev = devices.SimulatedDevice(dev_samples, snr_db=32, sample_rate=9.7e6)
    rx = DeviceT2Receiver(stream_batch=3)
    st, ts = _stream(dev, receiver=rx)
    assert st.frontend == "CorrectorChain"
    assert st.frames_decoded >= 5
    np.testing.assert_array_equal(ts, flat[:len(ts)])


@pytest.mark.parametrize("start", [-19, 0, 40])
def test_derotate_from_keeps_the_ramp_anchored_at_start(start):
    """The CFO correction of a tracked frame turns the buffer from the
    frame start on, with phase 0 at that start, also when P1 retiming put
    the start before the buffer: every sample at or after the start ends
    on the ramp, and samples before it are untouched."""
    x = np.ones(200, np.complex64)
    devices.derotate_from(x, start, 1234.5, devices.SAMPLE_RATE)
    j = np.arange(200)
    ramp = np.exp(-2j * np.pi * 1234.5 * (j - start) / devices.SAMPLE_RATE)
    on = j >= start
    np.testing.assert_allclose(x[on], ramp[on], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(x[~on], 1.0)


def test_device_chain_reads_where_its_host_bookkeeping_says():
    """A 3M-sample block at the SdrPlay rate (+0.625%): the device
    resampler must read at the positions the host advances in float64.
    A pure tone through the chain stays on the ideal tone's phase; with
    the ratio rounded to float32 the read position drifted ~0.07 samples
    over the block (0.09 rad at this tone)."""
    from sdr_receiver_dvb_t2_tpu.ops.frontend_device import (
        DeviceFrontendChain)
    fs_in, fs_out, f0 = 9.2e6, devices.SAMPLE_RATE, 1.9e6
    n = 3_000_000
    x = np.exp(2j * np.pi * f0 * np.arange(n) / fs_in).astype(np.complex64)
    chain = DeviceFrontendChain(in_rate=fs_in, out_rate=fs_out, block_len=n)
    y = chain.process(x)
    k = np.arange(len(y) - 20000, len(y))
    pos = chain.half + k * (fs_in / fs_out)        # input read positions
    ideal = np.exp(2j * np.pi * f0 * pos / fs_in)
    err = np.abs(np.angle(y[k] / ideal))
    assert len(y) > 2_900_000 and err.max() < 0.02, err.max()
