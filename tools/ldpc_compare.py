#!/usr/bin/env python
"""The two LDPC decoders of ops/ldpc_pallas.py side by side, at the bench's
code (64800-bit C2/3) and batch (128 codewords, one frame).

Checks, then times, `make_xla_decoder` (the plain XLA loop) against
`make_triton_decoder` (the Pallas kernel through Triton) on the same LLRs:

  - at float32 messages the hard bits and sweep counts must be identical;
  - at bf16 messages every codeword the XLA loop decodes must decode to
    the same bits;
  - then each decoder's time per call (one frame) in turns: XLA, Triton,
    Triton, XLA, each the median of --reps calls.

LLRs are BPSK over AWGN at each --sigma (near a 0.68 noise std a batch
needs about a dozen sweeps, as the 256QAM bench does at 19 dB), or a frame's bf16 LLRs saved by
`bench.py --dump-llrs` (--llrs FILE.npz, one (N, 128) array per key).
Needs a GPU; run from the repository root: python tools/ldpc_compare.py
"""
import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sigma", type=float, nargs="*", default=[0.68, 0.5])
    ap.add_argument("--llrs", default=None)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--warps", type=int, nargs="*", default=[8])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as ldpcmod
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame
    from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qc
    from sdr_receiver_dvb_t2_tpu.utils.jaxcache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    enable_compile_cache()
    print(f"device {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    frame, rate = FECFrame.NORMAL, CodeRate.C2_3
    code = ldpcmod.get_code(frame, rate)

    cases = []
    if args.llrs:
        with np.load(args.llrs) as z:
            cases = [(k, None, z[k]) for k in z.files]
    else:
        rng = np.random.default_rng(5)
        info = rng.integers(0, 2, (args.batch, code.k)).astype(np.uint8)
        cw = ldpcmod.encode(code, info)
        for sg in args.sigma:
            y = (1 - 2.0 * cw) + rng.normal(0, sg, cw.shape)
            llr = (2.0 * y / sg ** 2).astype(np.float32).T
            cases.append((f"sigma {sg:g}", cw.T, llr))

    ok_all = True
    for label, truth, llr in cases:
        x32 = jnp.asarray(llr, jnp.float32)
        x16 = jnp.asarray(llr, jnp.bfloat16)
        # agreement at f32 messages: identical bits and sweep counts
        a32 = qc.make_xla_decoder(frame, rate, c2v_dtype=None)
        b32 = qc.make_triton_decoder(frame, rate, c2v_dtype=None)
        ba, ia = a32(x32, 0)
        bb, ib = b32(x32, 0)
        same32 = bool((np.asarray(ba) == np.asarray(bb)).all()
                      and int(ia) == int(ib))
        print(f"[{label}] f32 messages: xla {int(ia)} sweeps, triton "
              f"{int(ib)} sweeps, bits identical={same32}")
        ok_all &= same32
        for warps in args.warps:
            a = qc.make_xla_decoder(frame, rate)
            b = qc.make_triton_decoder(frame, rate, num_warps=warps)
            t0 = time.perf_counter()
            ba, ia = jax.block_until_ready(a(x16, 0))
            ca = time.perf_counter() - t0
            t0 = time.perf_counter()
            bb, ib = jax.block_until_ready(b(x16, 0))
            cb = time.perf_counter() - t0
            ba, bb = np.asarray(ba), np.asarray(bb)
            same = (ba == bb).all(axis=0)
            if truth is not None:
                a_ok = (ba == truth).all(axis=0)
                msg = (f"xla decodes {int(a_ok.sum())}/{a_ok.size}, "
                       f"triton {int((bb == truth).all(axis=0).sum())}; "
                       f"of those xla decodes, triton differs on "
                       f"{int((a_ok & ~same).sum())}")
                ok_all &= not (a_ok & ~same).any()
            else:
                msg = f"codewords with differing bits {int((~same).sum())}"
                ok_all &= bool(same.all())
            print(f"[{label}] bf16 messages, {warps} warps: xla "
                  f"{int(ia)} sweeps, triton {int(ib)} sweeps; {msg}; "
                  f"first call (compile) xla {ca:.1f} s, triton {cb:.1f} s")

            def timed(fn, x):
                ts = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(x, 0))
                    ts.append(time.perf_counter() - t0)
                return statistics.median(ts) * 1e3

            ms = [timed(f, x16) for f in (a, b, b, a)]
            print(f"[{label}] per frame ({args.batch} codewords), turns "
                  f"xla/triton/triton/xla: {ms[0]:.3f} {ms[1]:.3f} "
                  f"{ms[2]:.3f} {ms[3]:.3f} ms")
    print("ldpc_compare", "OK" if ok_all else "MISMATCH")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
