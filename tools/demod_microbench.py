#!/usr/bin/env python
"""Drill into the per-class equalizer cost (the 'demod' stage of
path_microbench): times progressively larger sub-pipelines.

  slice : strided class slices only
  pilot : + pilot row gather + inv_ref scale
  interp: + stencil row gathers + FMA -> channel estimate
  div   : + complex divide (XLA native)
  rdiv  : divide replaced by conj-multiply + real reciprocal
  comp  : + composed data row gather + concat (full demod stage)
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

    f = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    p = T2Params(fft_mode=FFTMode.FFT_32K, guard=GuardInterval.GI_1_128,
                 pilot_pattern=PilotPattern.PP7, extended_carrier=True,
                 n_data=59)
    plp = PLPParams(constellation=Constellation.QAM256, rate=CodeRate.C2_3,
                    fec_frame=FECFrame.NORMAL, num_blocks_max=128,
                    time_il_length=1)
    demod = fusedpath.get_fused_demod(p)
    classes = demod.classes

    def classes_fn(x, mode):
        outs = []
        for c in classes:
            xc = jax.lax.slice_in_dim(
                x, c.start, c.start + c.step * (c.count - 1) + 1,
                c.step, axis=1)
            if mode == "slice":
                outs.append(jnp.sum(xc))
                continue
            pr = xc[c.pilot_rows]
            est_p = pr * c.inv_ref[:, :, None]
            if mode == "pilot":
                outs.append(jnp.sum(est_p) + jnp.sum(xc))
                continue
            il, ir, w = c.stencil
            w3 = w[..., None]
            ch = est_p[il] * (1.0 - w3) + est_p[ir] * w3
            if mode == "interp":
                outs.append(jnp.sum(ch) + jnp.sum(xc))
                continue
            if mode == "div":
                eq = xc / ch
            else:
                inv = 1.0 / (jnp.real(ch) ** 2 + jnp.imag(ch) ** 2)
                eq = xc * jnp.conj(ch) * inv
            if mode in ("div", "rdiv"):
                outs.append(jnp.sum(eq))
                continue
            outs.append(jnp.sum(eq[c.comp_rows]))
        return sum(jnp.real(o) + jnp.imag(o) for o in outs)

    rng = np.random.default_rng(0)
    xr = rng.normal(0, 1, (p.k_total, p.len_frame, f)).astype(np.float32)
    xi = rng.normal(0, 1, (p.k_total, p.len_frame, f)).astype(np.float32)
    d_xr, d_xi = jnp.asarray(xr), jnp.asarray(xi)

    for mode in ("slice", "pilot", "interp", "div", "rdiv", "comp"):
        @jax.jit
        def chain(a, b, n, mode=mode):
            def step(_, s):
                v = classes_fn(jax.lax.complex(s[0], s[1]), mode)
                return (a + v * 1e-20, b)
            s = jax.lax.fori_loop(0, n, step, (a, b))
            return classes_fn(jax.lax.complex(s[0], s[1]), mode)

        t0 = time.time()
        float(chain(d_xr, d_xi, 1))
        print(f"[{mode}] compile+first {time.time()-t0:.0f}s",
              file=sys.stderr)
        t1 = time.time(); float(chain(d_xr, d_xi, 1)); t1 = time.time()-t1
        reps = 8
        tn = time.time(); float(chain(d_xr, d_xi, 1+reps)); tn = time.time()-tn
        dt = (tn - t1) / reps
        print(f"[{mode}] {dt*1e3:.2f} ms/superstep ({dt/f*1e3:.2f} ms/frame)")


if __name__ == "__main__":
    main()
