"""The Triton LDPC kernel in interpret mode against the XLA early-exit
loop it must equal (ops/ldpc_pallas.py)."""
import numpy as np
import pytest

import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as ldpcmod
from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qc


@pytest.mark.parametrize("frame,rate,c2v_dtype", [
    (FECFrame.SHORT, CodeRate.C1_2, None),
    (FECFrame.SHORT, CodeRate.C1_2, jnp.bfloat16),
    (FECFrame.SHORT, CodeRate.C2_3, jnp.bfloat16),   # groups with 2 edges
    (FECFrame.SHORT, CodeRate.C3_5, jnp.bfloat16),   # none
])
def test_triton_interpret_matches_xla(frame, rate, c2v_dtype):
    """The kernel's arithmetic is the XLA schedule's: identical bits and
    sweep counts on a batch whose codewords converge at different sweeps,
    and a batch of 3 exercises the per-program grid."""
    code = ldpcmod.get_code(frame, rate)
    rng = np.random.default_rng(7)
    cw = ldpcmod.encode(code, rng.integers(0, 2, (3, code.k)).astype(
        np.uint8))
    llr = (1.5 * (1 - 2.0 * cw)
           + rng.normal(0, 1.0, (3, code.n))).astype(np.float32)
    kw = dict(max_iters=10, c2v_dtype=c2v_dtype)
    ba, ia = qc.make_xla_decoder(frame, rate, **kw)(jnp.asarray(llr.T), 2)
    bb, ib = qc.make_triton_decoder(frame, rate, interpret=True, **kw)(
        jnp.asarray(llr.T), 2)
    np.testing.assert_array_equal(np.asarray(ba), np.asarray(bb))
    assert int(ia) == int(ib)
