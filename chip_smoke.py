#!/usr/bin/env python
"""Quickest proof that the receiver runs on the GPU: python chip_smoke.py

One process, four phases; any failure exits non-zero.

  1. the first JAX device must be a GPU (exit 1 before any work otherwise);
     prints the card's name and power limit as nvidia-smi reports them;
  2. every kernel of the receive path against its plain reference at the
     bench's widths: the Triton LDPC decoder against the XLA loop on 128
     64800-bit codewords, the OFDM FFT against float64 NumPy at 32K with
     F=128, the BCH gate against `bch_check_host`, and the front end's
     per-frame NCO phase against a float64 evaluation;
  3. bench.py's superstep (32K, GI 1/128, PP7 extended, 59 data symbols,
     256QAM C2/3, 128 FEC blocks per frame) compiled at full width for a
     few frames, with its memory analysis, run once on frames synthesised
     and impaired as bench.py does: per-frame byte hashes, BCH clean and a
     bit-exact TS;
  4. `t2rx --stream --device-path` in-process on a 32K capture of the same
     mode made by the modulator, with CFO, at the SdrPlay rate: a
     bit-exact TS prefix, no TS errors, at least one F-frame superstep.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

SDRPLAY_RATE = 9.2e6
CFO_HZ = 850.0
STREAM_FRAMES = 10


def require_gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        sys.exit(1)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def check(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")
    print(f"  ok: {what}")


def ldpc_llrs(frame, rate, batch: int, sigma: float, seed: int = 5):
    """BPSK-over-AWGN LLRs (N, batch) and the transmitted codewords."""
    from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as ldpcmod
    code = ldpcmod.get_code(frame, rate)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    cw = ldpcmod.encode(code, info)
    y = (1 - 2.0 * cw) + rng.normal(0, sigma, cw.shape)
    return (2.0 * y / sigma ** 2).astype(np.float32).T, cw.T


def phase_ldpc(frame, rate, batch: int, sigma: float, kernel_build):
    """The kernel against the XLA loop: identical bits and sweeps at f32
    messages; at bf16 every codeword the XLA loop decodes decodes alike."""
    import jax.numpy as jnp
    from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qc
    llr, truth = ldpc_llrs(frame, rate, batch, sigma)
    for dt, name in ((None, "f32"), (jnp.bfloat16, "bf16")):
        x = jnp.asarray(llr, dt or jnp.float32)
        t0 = time.perf_counter()
        ba, ia = qc.make_xla_decoder(frame, rate, c2v_dtype=dt)(x, 0)
        ba = np.asarray(ba)
        t1 = time.perf_counter()
        bb, ib = kernel_build(frame, rate, c2v_dtype=dt)(x, 0)
        bb = np.asarray(bb)
        t2 = time.perf_counter()
        a_ok = (ba == truth).all(axis=0)
        same = (ba == bb).all(axis=0)
        print(f"  LDPC {name} messages, {batch} codewords: xla {int(ia)} "
              f"sweeps, {int(a_ok.sum())} decoded ({t1 - t0:.1f} s incl. "
              f"compile); kernel {int(ib)} sweeps ({t2 - t1:.1f} s)")
        if dt is None:
            check(bool(same.all()) and int(ia) == int(ib),
                  "LDPC kernel bits and sweeps identical to XLA at f32")
        else:
            check(not (a_ok & ~same).any(),
                  "LDPC kernel decodes every codeword XLA decodes, alike")
        check(int(a_ok.sum()) > 0, "the LDPC reference decodes codewords")


def phase_fft(n: int = 32768, frames: int = 128, syms: int = 2):
    """The receive path's carrier-major FFT (bf16 planes) against float64
    NumPy: bf16 storage of input and output bounds the error near -40 dB."""
    import jax
    import jax.numpy as jnp
    from sdr_receiver_dvb_t2_tpu.rx.fusedpath import fft_carrier_major
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(frames, syms, n))
         + 1j * rng.normal(size=(frames, syms, n))) / np.sqrt(2 * n)
    xr = jnp.asarray(x.real, jnp.bfloat16)
    xi = jnp.asarray(x.imag, jnp.bfloat16)
    t0 = time.perf_counter()
    yr, yi = jax.jit(fft_carrier_major, static_argnums=2)(
        xr, xi, jnp.bfloat16)
    got = (np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64))
    ref = np.fft.fft(np.asarray(xr, np.float64) + 1j
                     * np.asarray(xi, np.float64), axis=-1)
    ref = np.transpose(ref, (2, 1, 0))
    err_db = 10 * np.log10(np.mean(np.abs(got - ref) ** 2)
                           / np.mean(np.abs(ref) ** 2))
    print(f"  FFT {n} x {frames * syms}: error {err_db:.1f} dB "
          f"({time.perf_counter() - t0:.1f} s incl. compile)")
    check(err_db < -40.0, "FFT within bf16 quantisation of float64 NumPy")


def phase_bch(batch: int = 128):
    """The device BCH gate (bf16 GF(2) matmul) against the host gate at
    the bench's code, on clean and corrupted codewords."""
    import jax.numpy as jnp
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
        CodeRate, Constellation, FECFrame, PLPParams)
    from sdr_receiver_dvb_t2_tpu.dvbt2 import bch
    from sdr_receiver_dvb_t2_tpu.ops import fec_device
    plp = PLPParams(constellation=Constellation.QAM256, rate=CodeRate.C2_3,
                    fec_frame=FECFrame.NORMAL, num_blocks_max=batch)
    fec = plp.fec
    rng = np.random.default_rng(4)
    bb = rng.integers(0, 2, (batch, fec.k_bch)).astype(np.uint8)
    cw = bch.encode(plp.fec_frame, bb, fec.t_bch)
    cw[::3, rng.integers(0, fec.n_bch)] ^= 1
    gate = fec_device.make_bch_check_nb(plp.fec_frame, plp.rate)
    got = np.asarray(gate(jnp.asarray(cw.T)))
    want = fec_device.bch_check_host(plp, cw)
    print(f"  BCH gate: {int(got.sum())}/{batch} clean on the device, "
          f"{int(want.sum())} on the host")
    check(bool((got == want).all()) and 0 < want.sum() < batch,
          "BCH gate matches bch_check_host at full width")


def phase_nco(frames: int = 128):
    """The front end's per-frame NCO advance (compensated f32 arithmetic)
    against a float64 evaluation at the bench's frame length and F."""
    import jax
    import jax.numpy as jnp
    from sdr_receiver_dvb_t2_tpu.ops import frontend_device as fdev
    import bench
    p, _ = bench_mode()
    fs, cfo, ratio = 9.142857e6, bench.CFO_HZ, 1.0 + bench.SCO
    # bench.py's raw frame length at this mode
    n_in = int(np.ceil((p.frame_samples + 2 * bench.HALF) * ratio)) \
        + 4 * bench.HALF
    w, _, _, foff, _ = jax.jit(
        lambda c, r: fdev._nco_terms(c, r, 0.0, fs, 64, frames, n_in))(
            jnp.float32(cfo), jnp.float32(ratio))
    w64 = float(np.float32(w))
    ref = np.mod(np.arange(frames) * np.mod(w64 * n_in, 2 * np.pi),
                 2 * np.pi)
    d = np.angle(np.exp(1j * (np.asarray(foff, np.float64) - ref)))
    print(f"  NCO per-frame phase over {frames} frames: max error "
          f"{np.abs(d).max():.2e} rad")
    check(np.abs(d).max() < 2e-3, "NCO phase agrees with float64")


def phase_superstep(frames: int):
    import bench
    t0 = time.perf_counter()
    res = bench.main(["--frames", str(frames), "--snr", "0",
                      "--oracle-tracking", "--gate-only"])
    c = res["cells"][0]
    print(f"  superstep, {frames} frames: {c} "
          f"({time.perf_counter() - t0:.1f} s incl. compile)")
    check(c["hashes_ok"] and c["bch_ok"] and c["ts_bit_exact"],
          "superstep hashes, BCH clean and bit-exact TS")


def bench_mode():
    """bench.py's mode: 32K, GI 1/128, PP7 extended, 59 data symbols, one
    PLP of 256QAM C2/3 with 64800-bit FEC and 128 FEC blocks per frame."""
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
        CodeRate, Constellation, FECFrame, FFTMode, GuardInterval,
        PilotPattern, PLPParams, T2Params)
    p = T2Params(fft_mode=FFTMode.FFT_32K, guard=GuardInterval.GI_1_128,
                 pilot_pattern=PilotPattern.PP7, extended_carrier=True,
                 n_data=59)
    plp = PLPParams(constellation=Constellation.QAM256, rate=CodeRate.C2_3,
                    fec_frame=FECFrame.NORMAL, num_blocks_max=128,
                    time_il_length=1)
    return p, plp


def stream_capture(path: str, frames: int, p, plp):
    """A capture of mode (p, plp) from the modulator, at the SdrPlay rate,
    with CFO and a little noise: returns the TS it carries."""
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import SAMPLE_RATE
    from sdr_receiver_dvb_t2_tpu.rx import frontend as hostfe
    from sdr_receiver_dvb_t2_tpu.tx.modulator import T2Modulator
    mod = T2Modulator(p, [plp])
    rng = np.random.default_rng(9)
    ts = rng.integers(0, 256, (mod.packets_needed(frames) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    x = mod.modulate(ts.reshape(-1), frames).samples
    x = hostfe.sinc_resample(x, SAMPLE_RATE / SDRPLAY_RATE)
    n = np.arange(len(x))
    x = x * np.exp(2j * np.pi * CFO_HZ * n / SDRPLAY_RATE)
    x = x + 0.01 * (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x)))
    x.astype(np.complex64).tofile(path)
    return ts.reshape(-1)


def phase_stream(frames: int, p, plp, min_ts_bytes: int, argv=()):
    from sdr_receiver_dvb_t2_tpu.rx import cli
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        cap = os.path.join(tmp, "cap.cf32")
        out = os.path.join(tmp, "out.ts")
        t0 = time.perf_counter()
        sent = stream_capture(cap, frames, p, plp)
        t1 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([cap, "--stream", "--device-path", "--format",
                           "cf32", "--rate", str(SDRPLAY_RATE), "--out", out,
                           "--stats-json", *argv])
        stats = json.loads(buf.getvalue().strip().splitlines()[-1])
        got = np.fromfile(out, np.uint8)
        print(f"  stream: capture of {frames} frames built in "
              f"{t1 - t0:.1f} s, t2rx ran {time.perf_counter() - t1:.1f} s: "
              f"rc {rc}, frames {stats['frames']}, supersteps "
              f"{stats['device_supersteps']}, ts_errors "
              f"{stats['ts_errors']}, {len(got)} TS bytes")
    check(rc == 0 and stats["ts_errors"] == 0, "t2rx ran with no TS errors")
    check(len(got) >= min_ts_bytes and np.array_equal(got, sent[:len(got)]),
          "t2rx TS is a bit-exact prefix of the modulator's input")
    check(stats["device_supersteps"] >= 1, "at least one F-frame superstep")


def main():
    device = require_gpu()
    from sdr_receiver_dvb_t2_tpu.utils.jaxcache import enable_compile_cache
    from sdr_receiver_dvb_t2_tpu.utils.metrics import gpu_identity
    print(gpu_identity())
    print(f"device: {device}; compile cache {enable_compile_cache()}")

    from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame
    from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qc
    t0 = time.perf_counter()
    print("phase 2: kernels against their references")
    phase_ldpc(FECFrame.NORMAL, CodeRate.C2_3, 128, 0.68,
               qc.make_triton_decoder)
    phase_fft()
    phase_bch()
    phase_nco()
    print(f"phase 3: bench superstep ({time.perf_counter() - t0:.0f} s)")
    phase_superstep(frames=4)
    print(f"phase 4: t2rx --stream --device-path "
          f"({time.perf_counter() - t0:.0f} s)")
    p, plp = bench_mode()
    phase_stream(STREAM_FRAMES, p, plp, min_ts_bytes=188 * 1000)
    print(f"all phases passed in {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
