"""QC layered LDPC decoder tests: layout transforms, the XLA schedule and
its early-exit loop, the Triton kernel in interpret mode against that loop,
and the backend's choice of decoder.  The kernel compiled for the card is
checked by chip_smoke.py and by the gpu-marked test below."""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as ldpcmod
from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame
from sdr_receiver_dvb_t2_tpu.ops import ldpc as jldpc
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qc

RNG = np.random.default_rng(3)


def _noisy(frame, rate, b, snr_scale=3.0):
    code = ldpcmod.get_code(frame, rate)
    info = RNG.integers(0, 2, (b, code.k)).astype(np.uint8)
    cw = ldpcmod.encode(code, info)
    llr = (snr_scale * (1 - 2.0 * cw)
           + RNG.normal(0, 1.0, (b, code.n))).astype(np.float32)
    return code, cw, llr


@pytest.mark.parametrize("frame,rate", [(FECFrame.SHORT, CodeRate.C1_2),
                                        (FECFrame.NORMAL, CodeRate.C2_3),
                                        (FECFrame.SHORT, CodeRate.C3_5)])
def test_qc_layout_roundtrip(frame, rate):
    code, cw, llr = _noisy(frame, rate, 4)
    tab = qc.qc_tables(frame, rate)
    ti, tp = qc.llrs_to_qc(tab, llr)
    bits = qc.qc_to_bits(tab, ti, tp)
    np.testing.assert_array_equal(bits, (llr < 0).astype(np.uint8))


def test_qc_tables_cover_all_edges():
    tab = qc.qc_tables(FECFrame.SHORT, CodeRate.C1_2)
    code = ldpcmod.get_code(FECFrame.SHORT, CodeRate.C1_2)
    # total info edges must match the code construction
    assert int(tab.layer_deg.sum()) * 360 == len(code.acc_bit)


def test_xla_layered_decodes():
    frame, rate = FECFrame.SHORT, CodeRate.C1_2
    code, cw, llr = _noisy(frame, rate, 4)
    tab = qc.qc_tables(frame, rate)
    ti, tp = qc.llrs_to_qc(tab, llr)
    dec = qc.build_layered_decoder(frame, rate, iters=8)
    ti2, tp2 = dec(jnp.asarray(ti), jnp.asarray(tp))
    hard = qc.qc_to_bits(tab, np.asarray(ti2), np.asarray(tp2))
    assert jldpc.syndrome_ok(code, hard).all()
    np.testing.assert_array_equal(hard, cw)


def test_qc_syndrome_ok_xla():
    frame, rate = FECFrame.SHORT, CodeRate.C1_2
    code, cw, llr = _noisy(frame, rate, 6, snr_scale=20.0)  # clean
    tab = qc.qc_tables(frame, rate)
    ti, tp = qc.llrs_to_qc(tab, llr)
    ok = np.asarray(qc.qc_syndrome_ok(frame, rate,
                                      jnp.asarray(ti), jnp.asarray(tp)))
    ref = jldpc.syndrome_ok(code, (llr < 0).astype(np.uint8))
    np.testing.assert_array_equal(ok, ref)
    # flip one bit of lane 0 -> its syndrome must fail
    llr2 = llr.copy()
    llr2[0, 5] *= -1.0
    ti2, tp2 = qc.llrs_to_qc(tab, llr2)
    ok2 = np.asarray(qc.qc_syndrome_ok(frame, rate,
                                       jnp.asarray(ti2), jnp.asarray(tp2)))
    assert not ok2[0] and ok2[1:].all()




@functools.lru_cache(maxsize=None)
def xla_decoder(frame, rate, max_iters, c2v_dtype=None, layer_order=None):
    """One jitted decoder per configuration for the whole module: the
    unrolled sweep takes seconds to compile on the CPU."""
    return qc.make_xla_decoder(frame, rate, max_iters=max_iters,
                               c2v_dtype=c2v_dtype, layer_order=layer_order)


@functools.lru_cache(maxsize=None)
def triton_decoder(frame, rate, max_iters, c2v_dtype=None):
    return qc.make_triton_decoder(frame, rate, max_iters=max_iters,
                                  c2v_dtype=c2v_dtype, interpret=True)


@pytest.mark.parametrize("c2v_dtype", [None, jnp.bfloat16])
@pytest.mark.parametrize("layer_order", [None, "reversed"])
def test_xla_decoder_matches_fixed_sweeps(c2v_dtype, layer_order):
    """On input that never checks clean the early-exit loop runs
    max_iters sweeps of the stepper's schedule, in either layer order and
    at either message precision (and, natural order at float32, of the
    fixed-sweep decoder's)."""
    frame, rate = FECFrame.SHORT, CodeRate.C1_2
    tab = qc.qc_tables(frame, rate)
    llr = np.random.default_rng(11).normal(0, 1, (tab.n, 3)).astype(
        np.float32)
    bits, sweeps = xla_decoder(frame, rate, 3, c2v_dtype, layer_order)(
        jnp.asarray(llr))
    assert int(sweeps) == 3
    step = qc.build_layered_stepper(frame, rate, c2v_dtype=c2v_dtype,
                                    layer_order=layer_order)
    ti, tp = qc.llrs_nb_to_qc_jnp(tab, jnp.asarray(llr))
    c2v = jnp.zeros((tab.q, tab.degmax + 2, 360, 3),
                    c2v_dtype or jnp.float32)
    for _ in range(3):
        ti, tp, c2v = step(ti, tp, c2v)
    np.testing.assert_array_equal(np.asarray(bits),
                                  np.asarray(qc.qc_to_bits_nb_jnp(tab, ti,
                                                                  tp)))
    if c2v_dtype is None and layer_order is None:
        ti2, tp2 = qc.build_layered_decoder(frame, rate, iters=3)(
            *qc.llrs_nb_to_qc_jnp(tab, jnp.asarray(llr)))
        np.testing.assert_array_equal(
            np.asarray(bits), np.asarray(qc.qc_to_bits_nb_jnp(tab, ti2, tp2)))


def _decoder(impl, frame, rate, max_iters):
    build = xla_decoder if impl == "xla" else triton_decoder
    return build(frame, rate, max_iters)


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_early_exit_on_clean_input(impl):
    frame, rate = FECFrame.SHORT, CodeRate.C1_2
    code, cw, llr = _noisy(frame, rate, 3, snr_scale=8.0)
    bits, sweeps = _decoder(impl, frame, rate, 5)(jnp.asarray(llr.T))
    assert int(sweeps) == 1
    np.testing.assert_array_equal(np.asarray(bits).T, cw)


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_min_it_floor_delays_exit(impl):
    frame, rate = FECFrame.SHORT, CodeRate.C1_2
    code, cw, llr = _noisy(frame, rate, 3, snr_scale=8.0)
    bits, sweeps = _decoder(impl, frame, rate, 5)(jnp.asarray(llr.T), 4)
    assert int(sweeps) == 4
    np.testing.assert_array_equal(np.asarray(bits).T, cw)


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_garbage_runs_to_max_sweeps(impl):
    frame, rate = FECFrame.SHORT, CodeRate.C1_2
    code = ldpcmod.get_code(frame, rate)
    llr = np.random.default_rng(9).normal(0, 1, (code.n, 3)).astype(
        np.float32)
    bits, sweeps = _decoder(impl, frame, rate, 5)(jnp.asarray(llr))
    assert int(sweeps) == 5
    assert not jldpc.syndrome_ok(code, np.asarray(bits).T).any()


@pytest.mark.parametrize("batch", [1, 3, 128])
def test_any_batch_size_freezes_each_codeword(batch):
    """Each codeword is frozen from its own first clean sweep, so its bits
    do not depend on the batch it rides in: a mixed batch (a noisy
    codeword among clean ones) decodes each codeword as it decodes alone."""
    frame, rate = FECFrame.SHORT, CodeRate.C1_2
    code, cw, llr = _noisy(frame, rate, batch, snr_scale=8.0)
    _, cw1, llr1 = _noisy(frame, rate, 1, snr_scale=1.6)
    llr[0], cw[0] = llr1[0], cw1[0]
    dec = xla_decoder(frame, rate, 12)
    bits, sweeps = dec(jnp.asarray(llr.T))
    bits = np.asarray(bits)
    assert bits.shape == (code.n, batch) and bits.dtype == np.uint8
    alone, sweeps0 = dec(jnp.asarray(llr[:1].T))
    np.testing.assert_array_equal(bits[:, :1], np.asarray(alone))
    assert int(sweeps) == int(sweeps0)
    np.testing.assert_array_equal(bits.T, cw)


@pytest.mark.parametrize("backend,expect", [("cpu", "make_xla_decoder"),
                                            ("gpu", "make_triton_decoder"),
                                            ("rocm", None)])
def test_make_decoder_follows_backend(monkeypatch, backend, expect):
    calls = []
    for name in ("make_xla_decoder", "make_triton_decoder"):
        monkeypatch.setattr(qc, name, functools.partial(
            lambda n, *a, **k: calls.append(n) or n, name))
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expect is None:
        with pytest.raises(RuntimeError, match="rocm"):
            qc.make_decoder(FECFrame.SHORT, CodeRate.C1_2)
        assert calls == []
    else:
        assert qc.make_decoder(FECFrame.SHORT, CodeRate.C1_2) == expect
        assert calls == [expect]


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided here, never at import."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run on the card: pytest -m gpu)")
    return devs[0]


@pytest.mark.gpu
def test_triton_decoder_on_gpu_matches_xla(gpu_device):
    """The compiled kernel at the bench's code and batch against the XLA
    loop: identical bits and sweeps at float32 messages."""
    frame, rate = FECFrame.NORMAL, CodeRate.C2_3
    code = ldpcmod.get_code(frame, rate)
    rng = np.random.default_rng(5)
    cw = ldpcmod.encode(code, rng.integers(0, 2, (128, code.k)).astype(
        np.uint8))
    y = (1 - 2.0 * cw) + rng.normal(0, 0.68, cw.shape)
    x = jnp.asarray((2.0 * y / 0.68 ** 2).T, jnp.float32)
    ba, ia = qc.make_xla_decoder(frame, rate, c2v_dtype=None)(x)
    bb, ib = qc.make_triton_decoder(frame, rate, c2v_dtype=None)(x)
    np.testing.assert_array_equal(np.asarray(ba), np.asarray(bb))
    assert int(ia) == int(ib)
