"""chip_smoke.py off the card: it refuses to run without a GPU, and its
phases pass at small sizes on the CPU (the Triton kernel in interpret
mode, the streaming phase on an 8K short-code capture)."""
import functools
import os
import subprocess
import sys

import pytest

from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    (tmp_path / "chip_smoke.py").write_text(src)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_phase_ldpc_small():
    chip_smoke.phase_ldpc(FECFrame.SHORT, CodeRate.C1_2, 4, 0.8,
                          functools.partial(qc.make_triton_decoder,
                                            interpret=True))


@pytest.mark.parametrize("n", [1024, 8192, 32768])
def test_phase_fft(n):
    chip_smoke.phase_fft(n=n, frames=2, syms=2)


def test_phase_bch():
    chip_smoke.phase_bch(batch=6)


def test_phase_nco():
    chip_smoke.phase_nco(frames=128)


def test_phase_stream_small(capsys):
    """The in-process t2rx --stream --device-path phase on an 8K
    short-code capture at the SdrPlay rate (the CPU stands in)."""
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=3,
                    time_il_length=1)
    chip_smoke.phase_stream(10, p, plp, min_ts_bytes=188 * 10,
                            argv=["--platform", "cpu"])
    out = capsys.readouterr().out
    assert "supersteps" in out and "FAILED" not in out
