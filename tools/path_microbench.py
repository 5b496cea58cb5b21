#!/usr/bin/env python
"""Stage-level timing of the fused receive path on the GPU.

NOTE (round 4): the production head changed — the fused front end
(ops/frontend_device.make_frontend_symbols) now emits GI-stripped
FFT-ready symbol planes directly, so the [fft] prefix below includes a
GI-strip/reshape pass the pipeline no longer performs; use
`bench.py --profile` for the current head split (frontend only /
frontend+demod+LLR) and this tool for the demod-internal deltas
(fft vs equalize vs gathers vs LLR), which are unchanged.

Times nested prefixes of the MultiFramePath pipeline with data-dependent
chains, so the difference between consecutive prefixes is the cost of the added stage:

  fft      : GI strip + batched 32K FFT + carrier slice
  demod    : + per-class pilot equalize + composed row-gather deinterleave
  cells    : + transpose to (total, F, 2) + PLP composed gather
  llrs     : + separable LLRs + bit deinterleave row gather  (full _fn)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from sdr_receiver_dvb_t2_tpu.utils.jaxcache import enable_compile_cache
    enable_compile_cache()

    from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
        CodeRate, Constellation, FECFrame, FFTMode, GuardInterval,
        PilotPattern, PLPParams, T2Params)
    from sdr_receiver_dvb_t2_tpu.rx import fusedpath

    num_blocks = 128
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    p = T2Params(fft_mode=FFTMode.FFT_32K, guard=GuardInterval.GI_1_128,
                 pilot_pattern=PilotPattern.PP7, extended_carrier=True,
                 n_data=59)
    plp = PLPParams(constellation=Constellation.QAM256, rate=CodeRate.C2_3,
                    fec_frame=FECFrame.NORMAL, num_blocks_max=num_blocks,
                    time_il_length=1)
    mf = fusedpath.MultiFramePath(p, plp, num_blocks, n_frames)
    classes = mf.demod.classes
    nb, cpf = num_blocks, plp.cells_per_fec_block
    comp_cm = mf.single.comp.reshape(nb, cpf).T.reshape(-1)
    f = n_frames

    def fft_part(bodies):
        body = jax.lax.complex(bodies[..., 0], bodies[..., 1])
        sym = body.reshape(f, p.len_frame, p.symbol_size)[:, :, p.guard_size:]
        spec = jnp.fft.fftshift(jnp.fft.fft(sym, axis=-1), axes=-1)
        return spec[..., p.left_nulls:p.left_nulls + p.k_total]

    def trans_part(bodies):
        car = fft_part(bodies)
        return (jnp.transpose(jnp.real(car), (2, 1, 0)),
                jnp.transpose(jnp.imag(car), (2, 1, 0)))

    def demod_part(bodies):
        xr, xi = trans_part(bodies)
        outs_r, outs_i = [], []
        for c in classes:
            sl = lambda a: jax.lax.slice_in_dim(
                a, c.start, c.start + c.step * (c.count - 1) + 1,
                c.step, axis=1)
            xcr, xci = sl(xr), sl(xi)
            iref = c.inv_ref[:, :, None]
            epr = xcr[c.pilot_rows] * iref
            epi = xci[c.pilot_rows] * iref
            il, ir, w = c.stencil
            w3 = w[..., None]
            chr_ = epr[il] * (1.0 - w3) + epr[ir] * w3
            chi_ = epi[il] * (1.0 - w3) + epi[ir] * w3
            inv = 1.0 / (chr_ * chr_ + chi_ * chi_)
            eqr = (xcr * chr_ + xci * chi_) * inv
            eqi = (xci * chr_ - xcr * chi_) * inv
            outs_r.append(eqr[c.comp_rows].reshape(-1, f))
            outs_i.append(eqi[c.comp_rows].reshape(-1, f))
        return (jnp.concatenate(outs_r, axis=0),
                jnp.concatenate(outs_i, axis=0))

    def stage_fft(bodies, inv):
        x = fft_part(bodies)
        return jnp.sum(jnp.real(x) + jnp.imag(x))

    def stage_trans(bodies, inv):
        xr, xi = trans_part(bodies)
        return jnp.sum(xr) + jnp.sum(xi)

    def stage_demod(bodies, inv):
        fr, fi_ = demod_part(bodies)
        return jnp.sum(fr) + jnp.sum(fi_)

    def stage_cells(bodies, inv):
        fr, fi_ = demod_part(bodies)
        return jnp.sum(fr[comp_cm]) + jnp.sum(fi_[comp_cm])

    def stage_llrs(bodies, inv):
        return jnp.sum(mf._fn(bodies, inv).astype(jnp.float32))

    rng = np.random.default_rng(0)
    body = rng.normal(0, 0.3, (n_frames, p.len_frame * p.symbol_size, 2)
                      ).astype(np.float32)
    inv = jnp.float32(1000.0)
    d_bodies = jnp.asarray(body)

    for name, fn in (("fft", stage_fft),
                     ("trans", stage_trans),
                     ("demod", stage_demod),
                     ("cells", stage_cells), ("llrs", stage_llrs)):
        @jax.jit
        def chain(b, inv, n, fn=fn):
            def step(_, s):
                v = fn(s, inv)
                return b + v * 1e-20
            return fn(jax.lax.fori_loop(0, n, step, b), inv)

        t0 = time.time()
        float(chain(d_bodies, inv, 1))
        print(f"[{name}] compile+first {time.time()-t0:.0f}s",
              file=sys.stderr)
        t1 = time.time(); float(chain(d_bodies, inv, 1)); t1 = time.time()-t1
        reps = 8
        tn = time.time(); float(chain(d_bodies, inv, 1+reps))
        tn = time.time()-tn
        dt = (tn - t1) / reps
        print(f"[{name}] {dt*1e3:.2f} ms per {n_frames}-frame superstep "
              f"({dt/n_frames*1e3:.2f} ms/frame)")


if __name__ == "__main__":
    main()
