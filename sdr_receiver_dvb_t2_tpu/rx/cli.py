"""Receiver CLI — the framework's replacement for the reference's Qt GUI
(SURVEY.md §7 step 8): capture file in, TS out over UDP or to a file, with
the L1/SNR/sync observability the GUI panels provided as structured text.

    python -m sdr_receiver_dvb_t2_tpu.rx.cli capture.cf32 \
        --out udp://127.0.0.1:7654 --plp 0 --rate 9.2e6 --device sdrplay
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from ..io import iq as iqio
from ..io import ts_io
from . import frontend
from .receiver import T2Receiver


def _dump_l1(res) -> str:
    out = []
    if res.l1pre:
        out.append("--- L1-pre ---")
        for k, v in dataclasses.asdict(res.l1pre).items():
            out.append(f"  {k.upper():22s} {v}")
    if res.l1post:
        out.append("--- L1-post ---")
        p = res.l1post
        out.append(f"  NUM_PLP               {p.num_plp}")
        if p.fef:
            out.append(f"  FEF_TYPE              {p.fef[0]}")
            out.append(f"  FEF_LENGTH            {p.fef[1]}")
            out.append(f"  FEF_INTERVAL          {p.fef[2]}")
        for i, plp in enumerate(p.plp):
            for k, v in dataclasses.asdict(plp).items():
                out.append(f"  [{i}] {k.upper():20s} {v}")
        out.append("--- L1 dynamic ---")
        for i, dp in enumerate(p.dyn.plp):
            out.append(f"  [{i}] START {dp.start}  NUM_BLOCKS {dp.num_blocks}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="DVB-T2 receiver: IQ capture -> MPEG TS")
    ap.add_argument("input", help="IQ capture file (.cf32 | .ci16)")
    ap.add_argument("--format", choices=iqio.FORMATS, default=None,
                    help="input sample format (default: from extension)")
    ap.add_argument("--rate", type=float, default=None,
                    help="capture sample rate in Hz (device rate; "
                         "resampled to the bandwidth's elementary rate; "
                         "default: the elementary rate itself)")
    ap.add_argument("--bandwidth", type=float, default=8.0,
                    choices=(1.7, 5.0, 6.0, 7.0, 8.0, 10.0),
                    help="channel bandwidth in MHz (sets the elementary "
                         "rate, EN 302 755; the reference supports 8 MHz "
                         "only)")
    ap.add_argument("--device", choices=list(frontend.DEVICE_RATES) + ["raw"],
                    default="raw", help="device preset for the sample rate")
    ap.add_argument("--out", default="udp://127.0.0.1:7654",
                    help="TS sink: udp://host:port or a file path")
    ap.add_argument("--profile", choices=("base", "lite"), default="base",
                    help="which service to select by preamble type: the "
                         "base T2 signal or a T2-Lite service in its FEF "
                         "parts (no reference equivalent)")
    ap.add_argument("--plp", type=int, default=None,
                    help="decode only this PLP id")
    ap.add_argument("--regen", default=None, metavar="FILE",
                    help="write a regenerated T2-MI/TS feed of the decoded "
                         "signal (the regenerative-repeater role: clean BB "
                         "frames + received L1, REGEN_FLAG incremented; "
                         "one-shot path only)")
    ap.add_argument("--l1-dump", action="store_true",
                    help="print parsed L1 signalling")
    ap.add_argument("--stats-json", action="store_true",
                    help="print receiver stats as JSON")
    ap.add_argument("--plots", default=None, metavar="DIR",
                    help="dump spectrum/constellation/P1-correlation PNGs")
    ap.add_argument("--jax-ldpc", action="store_true",
                    help="use the batched JAX LDPC decoder")
    ap.add_argument("--stream", action="store_true",
                    help="continuous streaming receive through the device "
                         "layer: persistent lock across blocks, closed-loop "
                         "retune/AGC/CFO/SCO feedback (input may be "
                         "sdr:NAME for a live front-end)")
    ap.add_argument("--device-path", action="store_true",
                    help="run the streaming bulk path on the accelerator "
                         "(DeviceT2Receiver: fused demod + layered LDPC)")
    ap.add_argument("--ring", action="store_true",
                    help="ingest through the native SPSC ring on a reader "
                         "thread (elastic buffering)")
    ap.add_argument("--no-agc", action="store_true",
                    help="disable the AGC gain loop")
    ap.add_argument("--control", type=int, default=None, metavar="PORT",
                    help="open a runtime control TCP endpoint (0 = pick a "
                         "free port, printed to stderr): PLP <id>|ALL, "
                         "OUT <path>, UDP <host:port>, STATUS, STOP — "
                         "switch the TS sink / PLP selection of the "
                         "RUNNING receiver without losing lock (stream "
                         "mode only)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="write streaming resume checkpoints to PATH")
    ap.add_argument("--resume", action="store_true",
                    help="resume streaming from --checkpoint PATH")
    ap.add_argument("--live", action="store_true",
                    help="live terminal dashboard (lock state, SNR, loops, "
                         "TS counters, constellation) — the GUI panels as "
                         "ANSI redraw on stderr")
    ap.add_argument("--frequency", type=float, default=0.0,
                    help="RF center frequency in Hz for live front ends "
                         "(sdr:sdrplay / sdr:airspy / tcp://)")
    ap.add_argument("--gain", type=float, default=0.0,
                    help="initial gain for live front ends (mir_sdr gain "
                         "reduction dB for sdrplay, sensitivity index for "
                         "airspy; <0 = start in hardware-AGC posture)")
    ap.add_argument("--max-blocks", type=int, default=None)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a jax.profiler device trace of the run "
                         "(view with xprof/tensorboard)")
    ap.add_argument("--platform", choices=["auto", "cpu"], default="auto",
                    help="force the JAX backend: cpu runs host-only even "
                         "where a GPU is present")
    args = ap.parse_args(argv)

    if args.regen and args.plp is not None:
        # a regenerated feed advertises a full clean multiplex; a
        # plp-filtered decode cannot provide every PLP's BB frames
        ap.error("--regen requires a full decode: drop --plp")

    if args.platform == "cpu" or args.device_path:
        import jax
        if args.platform == "cpu":
            jax.config.update("jax_platforms", "cpu")
        # the device path compiles for minutes at 32K; a warm cache cuts
        # later runs to seconds
        from ..utils.jaxcache import enable_compile_cache
        enable_compile_cache()

    from ..dvbt2.params import Bandwidth
    fs = Bandwidth.from_mhz(args.bandwidth).sample_rate

    if args.stream or args.input.startswith("sdr:"):
        from ..io import devices
        if args.input.startswith("sdr:"):
            dev = devices.DEVICES[args.input[4:]]()
        elif args.input.startswith("tcp://"):
            # network front end (Pluto-style remote radio, io/net.py)
            from ..io.net import NetworkDevice
            dev = NetworkDevice.from_url(args.input)
        else:
            # the capture's rate: --rate if declared, else the bandwidth's
            # elementary rate (a FileDevice defaulting to 9.14 Msps would
            # make the chain resample a narrow-band capture to mush)
            dev = devices.FileDevice(
                args.input, args.format,
                sample_rate=args.rate if args.rate is not None else fs)
        dev.init(frequency_hz=args.frequency, gain_db=args.gain)
        ctrl = None
        if args.control is not None:
            # live control endpoint: PLP/OUT/UDP/STATUS/STOP mid-run
            # (bb_de_header.cpp:500-525 set_out parity, headless form)
            from ..io import control as ioctl
            if args.out.startswith("udp:"):
                host, _, port = args.out[4:].lstrip("/").rpartition(":")
                csink = ioctl.SwitchableSink(
                    udp=(host or "127.0.0.1", int(port)))
            else:
                csink = ioctl.SwitchableSink(path=args.out)
            ctrl = ioctl.ControlServer(csink, port=args.control)
            print(f"control channel on 127.0.0.1:{ctrl.port}",
                  file=sys.stderr)
            sink = None
        else:
            sink = ts_io.open_sink(args.out)
        if args.device_path:
            from .device_receiver import DeviceT2Receiver
            rx = DeviceT2Receiver(plp_filter=args.plp, profile=args.profile,
                                  fs=fs)
        else:
            rx = T2Receiver(plp_filter=args.plp, profile=args.profile,
                            fs=fs)
        sr = devices.StreamingReceiver(
            dev, rx, agc=not args.no_agc, use_ring=args.ring,
            checkpoint_path=args.checkpoint)
        if args.trace:
            import contextlib
            from ..utils.metrics import device_trace
            tracer = device_trace(args.trace)
        else:
            import contextlib
            tracer = contextlib.nullcontext()
        dash = None
        if args.live:
            from ..utils.live import LiveDashboard
            dash = LiveDashboard()
        with tracer:
            st = sr.run(ts_sink=(ctrl.sink if ctrl else sink.write),
                        max_blocks=args.max_blocks,
                        resume=args.checkpoint if args.resume else None,
                        capture_debug=args.plots is not None,
                        on_block=dash.update if dash else None,
                        control=ctrl)
        if dash:
            dash.close()
        if ctrl is not None:
            ctrl.close()
            ctrl.sink.close()
        else:
            sink.close()
        if args.plots and st.debug is not None:
            from ..utils import plots
            files = plots.stage_plots(st.debug, st.snr_db, st.timing,
                                      args.plots)
            print(f"stage plots -> {args.plots}/ ({len(files)} files)",
                  file=sys.stderr)
        snr = float(np.mean(st.snr_db)) if st.snr_db else float("nan")
        print(f"blocks={st.blocks} frames={st.frames_decoded} "
              f"(skipped {st.frames_skipped}, reacq {st.reacquisitions}) "
              f"retunes={st.retune_requests} gain_steps={st.gain_steps} "
              f"ts_bytes={st.ts_bytes} ts_errors={st.ts_errors} "
              f"cfo={st.cfo_hz:.1f} Hz sco={st.sco_ppm:.1f} ppm "
              f"snr={snr:.1f} dB overruns={st.overruns}", file=sys.stderr)
        if args.stats_json:
            d = st.metrics.as_dict()
            d["frames"] = st.frames_decoded
            d["ts_packets"] = st.ts_packets
            d["ts_errors"] = st.ts_errors
            d["device_supersteps"] = getattr(rx, "batch_supersteps", 0)
            print(json.dumps(d))
        return 0 if st.frames_decoded > 0 else 1

    x = iqio.read_iq(args.input, args.format)
    rate = frontend.DEVICE_RATES.get(
        args.device, args.rate if args.rate is not None else fs)
    print(f"read {len(x)} samples @ {rate/1e6:.4f} Msps", file=sys.stderr)
    t0 = time.time()
    if abs(rate - fs) > 1.0:
        x = frontend.device_to_elementary(x, rate, target_rate=fs)
        print(f"front end -> {len(x)} samples @ {fs/1e6:.4f} Msps",
              file=sys.stderr)

    factory = None
    if args.jax_ldpc:
        from ..dvbt2 import ldpc as ldpcmod
        from ..ops import ldpc as jldpc

        def factory(plp_cfg):
            code = ldpcmod.get_code(plp_cfg.fec_frame, plp_cfg.rate)
            dec = jldpc.make_decoder(code, iters=25)
            return lambda llrs: np.asarray(
                dec(np.asarray(llrs, np.float32)))

    rx = T2Receiver(plp_filter=args.plp, ldpc_decode_fn_factory=factory,
                    profile=args.profile, fs=fs)
    regen = None
    if args.regen:
        from ..tx.t2mi import T2MIRegenerator
        regen = T2MIRegenerator()
        rx.regen_sink = regen
    res = rx.receive(x)
    dt = time.time() - t0
    if regen is not None and regen.frames:
        feed = regen.t2mi_ts()
        feed.tofile(args.regen)
        print(f"regenerated {len(regen.frames)} frames -> "
              f"{feed.shape[0]} T2-MI TS packets -> {args.regen}",
              file=sys.stderr)

    if args.l1_dump:
        print(_dump_l1(res))
    s = res.stats
    snr = float(np.mean(s.snr_db)) if s.snr_db else float("nan")
    print(f"frames={s.frames_decoded} packets={s.ts_packets} "
          f"ts_errors={s.ts_errors} snr={snr:.1f} dB "
          f"cfo={s.cfo_hz:.1f} Hz l1_failures={s.l1_failures} "
          f"({len(x)/dt/1e6:.1f} Msps throughput)", file=sys.stderr)
    if args.stats_json:
        print(json.dumps({
            "frames": s.frames_decoded, "packets": s.ts_packets,
            "ts_errors": s.ts_errors, "snr_db": snr, "cfo_hz": s.cfo_hz,
            "l1_failures": s.l1_failures,
            "throughput_msps": len(x) / dt / 1e6,
            "plp": {str(k): dataclasses.asdict(v)
                    for k, v in s.plp_stats.items()},
        }))

    if args.plots:
        import os
        from ..utils import plots
        os.makedirs(args.plots, exist_ok=True)
        plots.spectrum_png(x[:2_000_000], os.path.join(args.plots,
                                                       "spectrum.png"))
        plots.p1_correlation_png(x[:300_000],
                                 os.path.join(args.plots, "p1_corr.png"))
        print(f"plots -> {args.plots}/", file=sys.stderr)

    if len(res.ts):
        sink = ts_io.open_sink(args.out)
        sink.write(res.ts)
        sink.close()
        print(f"wrote {len(res.ts)} TS bytes -> {args.out}", file=sys.stderr)
    return 0 if s.frames_decoded > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
