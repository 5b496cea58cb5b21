"""DeviceT2Receiver's LDPC: one decoder per code for every batch size,
chosen by the backend, and an error on a backend with none."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as ldpcmod
from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
    CodeRate, Constellation, FECFrame, PLPParams)
from sdr_receiver_dvb_t2_tpu.rx import decode as rxdecode
from sdr_receiver_dvb_t2_tpu.rx.device_receiver import DeviceT2Receiver

PLP = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                fec_frame=FECFrame.SHORT, num_blocks_max=3)


def _llrs(batch, seed=1):
    code = ldpcmod.get_code(PLP.fec_frame, PLP.rate)
    rng = np.random.default_rng(seed)
    cw = ldpcmod.encode(code, rng.integers(0, 2, (batch, code.k)).astype(
        np.uint8))
    llr = 6.0 * (1 - 2.0 * cw) + rng.normal(0, 1.0, cw.shape)
    return jnp.asarray(llr.T, jnp.bfloat16), cw


def test_one_decoder_for_any_batch_size():
    rx = DeviceT2Receiver()
    pstat = rxdecode.PLPDecodeStats()
    for batch in (1, 3, 5):
        llr, cw = _llrs(batch, seed=batch)
        bits = rx._decode_ldpc(PLP, llr, pstat)
        np.testing.assert_array_equal(bits, cw)
    assert len(rx._decoders) == 1
    assert pstat.ldpc_iters == [1, 1, 1]


def test_unknown_backend_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    rx = DeviceT2Receiver()
    llr, _ = _llrs(2)
    with pytest.raises(RuntimeError, match="no LDPC decoder"):
        rx._decode_ldpc(PLP, llr, rxdecode.PLPDecodeStats())
