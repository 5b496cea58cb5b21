"""Device-side FEC tail: batched BCH parity gate (a matmul over GF(2))
and BB descramble/byte-pack, vs the scalar host implementations."""
import numpy as np
import jax.numpy as jnp
import pytest

from sdr_receiver_dvb_t2_tpu.dvbt2 import bch, bbframe
from sdr_receiver_dvb_t2_tpu.dvbt2.params import (CodeRate, FECFrame,
                                                  fec_params)
from sdr_receiver_dvb_t2_tpu.ops import fec_device as fd

RNG = np.random.default_rng(7)


def _codewords(frame, rate, b):
    fec = fec_params(frame, rate)
    info = RNG.integers(0, 2, (b, fec.k_bch)).astype(np.uint8)
    return fec, bch.encode(frame, info, fec.t_bch)


@pytest.mark.parametrize("frame,rate", [(FECFrame.NORMAL, CodeRate.C2_3),
                                        (FECFrame.NORMAL, CodeRate.C1_2),
                                        (FECFrame.SHORT, CodeRate.C3_4)])
def test_bch_check_device_and_host(frame, rate):
    fec, cw = _codewords(frame, rate, 6)
    dirty = cw.copy()
    dirty[1, 77] ^= 1
    dirty[3, fec.n_bch - 5] ^= 1
    expect = [True, False, True, False, True, True]
    ok_dev = np.asarray(fd.make_bch_check_nb(frame, rate)(
        jnp.asarray(dirty.T)))
    assert ok_dev.tolist() == expect
    plp = type("P", (), {"fec_frame": frame, "fec": fec})()
    assert fd.bch_check_host(plp, dirty).tolist() == expect
    # agreement with the per-codeword syndrome gate
    for i in range(6):
        assert (not bch.syndromes(frame, dirty[i], fec.t_bch).any()) \
            == expect[i]


def test_remainder_matrix_matches_encoder():
    """Every encoder output must have zero remainder; a random non-codeword
    must not (g(x) | c(x) <=> all syndromes zero)."""
    frame, rate = FECFrame.SHORT, CodeRate.C1_2
    fec, cw = _codewords(frame, rate, 2)
    rm = fd.remainder_matrix(frame, fec.n_bch, fec.t_bch)
    rem = (cw.astype(np.int64) @ rm.astype(np.int64)) & 1
    assert not rem.any()
    bad = RNG.integers(0, 2, (2, fec.n_bch)).astype(np.uint8)
    rem2 = (bad.astype(np.int64) @ rm.astype(np.int64)) & 1
    assert rem2.any()


def test_bb_bytes_device_matches_host():
    frame, rate = FECFrame.SHORT, CodeRate.C1_2
    fec, cw = _codewords(frame, rate, 4)
    by = np.asarray(fd.make_bb_bytes_nb(frame, rate)(jnp.asarray(cw.T)))
    ref = np.packbits(bbframe.scramble(cw[:, :fec.k_bch]), axis=1)
    np.testing.assert_array_equal(by.T.astype(np.uint8), ref)
