#!/usr/bin/env python
"""BER validation: the layered decoder (10 sweeps, f32/bf16 messages,
natural and reversed layer order) vs the XLA flooding decoder (25 iters)
near the code threshold.  Runs on the backend's decoder
(ops.ldpc_pallas.make_decoder) for the production schedule.

Evidence that the fast layered schedule + reduced precision do not cost
operating-point performance (the reference runs <=25 layered iterations in
int8, ldpc_decoder.h:62)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax.numpy as jnp
    from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as L
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame
    from sdr_receiver_dvb_t2_tpu.ops import ldpc as jldpc
    from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qldpc

    frame, rate = FECFrame.NORMAL, CodeRate.C2_3
    code = L.get_code(frame, rate)
    B = 128
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (B, code.k)).astype(np.uint8)
    cw = L.encode(code, info)
    tx = (1.0 - 2.0 * cw).astype(np.float32)

    flood = jldpc.make_decoder(code, iters=25, dtype="bfloat16")
    # the early-exit decoders with the floor at max_iters run exactly 10
    # sweeps; the production REVERSED schedule is evidence the permuted
    # order costs no BER either
    layered = {
        "layered10_f32": qldpc.make_xla_decoder(
            frame, rate, max_iters=10, c2v_dtype=None, layer_order=None),
        "layered10_bf16": qldpc.make_xla_decoder(
            frame, rate, max_iters=10, layer_order=None),
        "layered10_bf16_rev": qldpc.make_decoder(frame, rate, max_iters=10),
    }
    # rate-2/3 BPSK threshold is around Eb/N0 ~ 2 dB -> sigma ~ 0.8
    for sigma in (0.74, 0.78, 0.82, 0.88):
        llr = (2.0 / sigma**2) * (tx + sigma * rng.normal(
            0, 1.0, (B, code.n))).astype(np.float32)
        row = {"flood25_bf16": (np.asarray(flood(jnp.asarray(llr)))
                                != cw).mean()}
        for name, dec in layered.items():
            bits, _ = dec(jnp.asarray(llr.T), 10)
            row[name] = (np.asarray(bits).T != cw).mean()
        print(f"sigma={sigma}: " + "  ".join(
            f"{k}={v:.2e}" for k, v in row.items()), flush=True)


if __name__ == "__main__":
    main()
