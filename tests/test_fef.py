"""Future Extension Frame (FEF) support, clause 8.4 of EN 302 755.

FEF parts — arbitrary non-T2 content with their own NON_T2 P1, inserted
after every FEF_INTERVAL-th T2-frame — are how real networks multiplex
T2-Lite and other services into a T2 signal.  The reference receiver has
NO FEF support (it would lose lock at the first FEF part); here the
modulator inserts and signals them (L1-pre S2_FIELD2 + L1-post
FEF_TYPE/LENGTH/INTERVAL) and both receiver paths schedule the frame grid
around them: acquisition skips the FEF P1 (S1 announces non-T2), the
one-shot and streaming trackers stride FRAME_LENGTH + FEF_LENGTH after
qualifying frames, and the SCO estimator measures over the true gaps.
"""
import numpy as np
import pytest

from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu.io import devices
from sdr_receiver_dvb_t2_tpu.rx import p1_detect as rxp1
from sdr_receiver_dvb_t2_tpu.rx.receiver import T2Receiver
from sdr_receiver_dvb_t2_tpu.tx.modulator import T2Modulator, awgn

FEF_LEN = 30000
FEF_INTERVAL = 2


def _fef_waveform(n_frames=6, seed=5, interval=FEF_INTERVAL,
                  fef_len=FEF_LEN):
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9, fef=(0, fef_len, interval))
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


def test_fef_tx_structure_and_signalling():
    """The emitted stream is lengthened by exactly the FEF parts, each FEF
    part starts with a NON_T2 P1, and L1 signals the FEF geometry."""
    n = 4
    flat, samples, p = _fef_waveform(n)
    n_fef = sum(1 for f in range(n) if (f + 1) % FEF_INTERVAL == 0)
    assert len(samples) == n * p.frame_samples + n_fef * FEF_LEN
    # FEF P1 is decodable and announces a non-T2 transmission
    fef_start = FEF_INTERVAL * p.frame_samples + (0) * FEF_LEN
    # a peak metric with the structural phase only = zero measured CFO
    m0 = np.exp(2j * np.pi * rxp1.P1_C / rxp1.P1_A)
    res = rxp1.decode_p1(samples, fef_start, m0)
    assert res is not None and res.s1 == 2 and res.s2_field2 == 1
    # the T2 frames' own P1s flag mixed preamble types (S2 field2)
    res0 = rxp1.decode_p1(samples, 0, m0)
    assert res0 is not None and res0.s1 == 0 and res0.s2_field2 == 1
    # L1 signalling round-trip
    mod = T2Modulator(p, [PLPParams(constellation=Constellation.QAM16,
                                    rate=CodeRate.C1_2,
                                    fec_frame=FECFrame.SHORT,
                                    num_blocks_max=3, time_il_length=1)])
    from sdr_receiver_dvb_t2_tpu.dvbt2 import l1 as l1mod
    pre, post = l1mod.build_l1(p, mod.plps, num_frames=n)
    assert pre.s2_field2 == 1
    assert post.fef == (0, FEF_LEN, FEF_INTERVAL)


def test_fef_oneshot_receive_bit_exact():
    """One-shot receive() strides over the FEF parts: every T2-frame
    decodes, TS bit-exact, under AWGN."""
    flat, samples, p = _fef_waveform(6)
    x = awgn(samples, 25.0, seed=1)
    res = T2Receiver().receive(x)
    assert res.stats.frames_decoded == 6
    assert res.stats.ts_errors == 0
    got = res.ts
    assert len(got) >= 30 * 188
    np.testing.assert_array_equal(got, flat[:len(got)])
    assert res.params.fef == (0, FEF_LEN, FEF_INTERVAL)


def test_fef_streaming_no_reacquisition():
    """The streaming tracker's predicted FRAME_IDX counter schedules the
    grid around FEF parts: all frames decode across block boundaries with
    zero reacquisitions and zero skips."""
    flat, samples, p = _fef_waveform(6)
    dev = devices.SimulatedDevice(samples, snr_db=30)
    got = []
    sr = devices.StreamingReceiver(dev, acq_seconds=0.025,
                                   block_seconds=0.007)
    st = sr.run(ts_sink=got.append)
    assert st.frames_decoded == 6
    assert st.frames_skipped == 0
    assert st.reacquisitions == 0
    assert st.ts_errors == 0
    ts = np.concatenate(got)
    np.testing.assert_array_equal(ts, flat[:len(ts)])


def test_fef_acquisition_skips_fef_p1():
    """A capture that BEGINS just before a FEF part: the first decodable
    P1 is the FEF's NON_T2 P1.  Acquisition must reject it (S1 gate) and
    lock onto the following T2 frame."""
    flat, samples, p = _fef_waveform(6)
    # cut 256 samples before the first FEF part (after frame idx 1)
    cut = 2 * p.frame_samples - 256
    x = samples[cut:]
    res = T2Receiver().receive(x)
    # frames 2..5 remain after the cut
    assert res.stats.frames_decoded == 4
    assert res.stats.ts_errors == 0
    tail = bytes(np.asarray(res.ts[: 8 * 188], np.uint8))
    assert bytes(flat).find(tail) % 188 == 0


def test_fef_device_path_supersteps():
    """The fused device streaming path (DeviceT2Receiver, F-frame
    supersteps) across FEF parts: batch starts are non-contiguous (the
    gap between consecutive frames includes FEF_LENGTH) and every frame
    still decodes bit-exact with the batched path engaged."""
    from sdr_receiver_dvb_t2_tpu.rx.device_receiver import DeviceT2Receiver
    flat, samples, p = _fef_waveform(8)
    dev = devices.SimulatedDevice(samples, snr_db=32)
    rx = DeviceT2Receiver(stream_batch=3)
    got = []
    sr = devices.StreamingReceiver(dev, acq_seconds=0.025,
                                   block_seconds=0.007, receiver=rx)
    st = sr.run(ts_sink=got.append)
    assert st.frames_decoded == 8
    assert st.frames_skipped == 0
    assert st.reacquisitions == 0
    assert rx.batch_supersteps >= 1
    ts = np.concatenate(got)
    np.testing.assert_array_equal(ts, flat[:len(ts)])


def test_fef_interval_one_every_frame():
    """FEF_INTERVAL=1 (a FEF part after every T2-frame) still tracks."""
    flat, samples, p = _fef_waveform(4, interval=1, fef_len=12000)
    res = T2Receiver().receive(samples)
    assert res.stats.frames_decoded == 4
    np.testing.assert_array_equal(res.ts, flat[:len(res.ts)])


def test_fef_multiplp_inband_streaming():
    """Integration: FEF parts + two PLPs + in-band type-A signalling
    through the streaming receiver — the features must compose (FEF
    strides between frames, per-PLP slices inside them, in-band payloads
    in the BB padding)."""
    from sdr_receiver_dvb_t2_tpu.tx.modulator import T2Modulator
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9, fef=(0, 20000, 2))
    plps = [PLPParams(plp_id=0, constellation=Constellation.QAM16,
                      rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                      num_blocks_max=2, time_il_length=1, in_band_a=True),
            PLPParams(plp_id=1, constellation=Constellation.QPSK,
                      rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                      rotated=False, num_blocks_max=1, time_il_length=1)]
    mod = T2Modulator(p, plps)
    rng = np.random.default_rng(11)
    n_frames = 6
    ts = rng.integers(0, 256, (mod.packets_needed(n_frames) + 6, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    out = mod.modulate(ts.reshape(-1), n_frames)
    dev = devices.SimulatedDevice(out.samples, snr_db=30)
    got = []
    sr = devices.StreamingReceiver(dev, acq_seconds=0.025,
                                   block_seconds=0.007)
    st = sr.run(ts_sink=got.append)
    assert st.frames_decoded == n_frames
    assert st.reacquisitions == 0
    assert st.ts_errors == 0
    # every recovered packet is a source packet (two PLPs interleave the
    # source round-robin, so exact ordering is per-PLP)
    src = {p_.tobytes() for p_ in ts}
    rec = np.concatenate(got)
    assert len(rec) >= 20 * 188
    for pkt in rec.reshape(-1, 188):
        assert pkt.tobytes() in src


def test_fef_checkpoint_resume(tmp_path):
    """Checkpoint/resume across a FEF-bearing stream: the resumed run
    re-acquires (fresh FRAME_IDX from its own L1) and the concatenated TS
    equals the uninterrupted run's."""
    from sdr_receiver_dvb_t2_tpu.utils.checkpoint import StreamCheckpoint
    flat, samples, p = _fef_waveform(8)
    ck_path = str(tmp_path / "fef.ck")

    dev0 = devices.SimulatedDevice(samples, snr_db=32)
    got0 = []
    sr0 = devices.StreamingReceiver(dev0, acq_seconds=0.025,
                                    block_seconds=0.007)
    st0 = sr0.run(ts_sink=got0.append)
    assert st0.frames_decoded == 8
    ts_full = np.concatenate(got0)

    dev1 = devices.SimulatedDevice(samples, snr_db=32)
    got1 = []
    sr1 = devices.StreamingReceiver(dev1, acq_seconds=0.025,
                                    block_seconds=0.007,
                                    checkpoint_path=ck_path,
                                    checkpoint_every=2)
    sr1.run(ts_sink=got1.append, max_blocks=6)
    ck = StreamCheckpoint.load(ck_path)
    assert ck.frames_decoded >= 2

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


def test_fef_miso_streaming():
    """MISO + FEF: both transmitter groups emit the same FEF part; the
    combined two-path channel stream decodes with the FEF-aware grid."""
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import Preamble
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9, miso=True, preamble=Preamble.T2_MISO,
                 fef=(0, 25000, 2))
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, rotated=True,
                    num_blocks_max=3, time_il_length=1)
    mod = T2Modulator(p, [plp])
    rng = np.random.default_rng(23)
    ts = rng.integers(0, 256, (mod.packets_needed(4) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    out = mod.modulate(ts.reshape(-1), 4)
    assert len(out.samples) == len(out.samples2)

    def ch(x, taps):
        return np.convolve(x, taps)[:len(x)].astype(np.complex64)

    y = (ch(out.samples, [1.0, 0.08j])
         + ch(out.samples2, [0.0, 0.0, 0.6 * np.exp(0.7j), -0.05]))
    dev = devices.SimulatedDevice(y, snr_db=30)
    got = []
    sr = devices.StreamingReceiver(dev, acq_seconds=0.025,
                                   block_seconds=0.007)
    st = sr.run(ts_sink=got.append)
    assert st.frames_decoded == 4
    assert st.ts_errors == 0
    flat = ts.reshape(-1)
    rec = np.concatenate(got)
    np.testing.assert_array_equal(rec, flat[:len(rec)])


def test_fef_superframe_wrap_odd_interval():
    """NUM_T2_FRAMES=3 with FEF_INTERVAL=2: the FEF schedule is irregular
    across the superframe boundary (FEF after wrapped FRAME_IDX 1 only).
    Two concatenated superframes must track straight through — the
    predicted counter wraps at NUM_T2_FRAMES like the on-air field."""
    flat, samples, p = _fef_waveform(3, interval=2)
    two = np.concatenate([samples, samples])
    dev = devices.SimulatedDevice(two, snr_db=30)
    got = []
    sr = devices.StreamingReceiver(dev, acq_seconds=0.025,
                                   block_seconds=0.007)
    st = sr.run(ts_sink=got.append)
    assert st.frames_decoded == 6
    assert st.frames_skipped == 0
    assert st.reacquisitions == 0
    rec = np.concatenate(got)
    # each superframe carries the same TS prefix; every recovered packet
    # must be a source packet — except the 0xF0-padded TEI flush at the
    # concatenation splice (the TS byte chain restarts there by design)
    src = {p_.tobytes() for p_ in flat.reshape(-1, 188)}
    clean = [pkt for pkt in rec.reshape(-1, 188) if not (pkt[1] & 0x80)]
    assert len(clean) >= len(rec) // 188 - 2
    for pkt in clean:
        assert pkt.tobytes() in src
