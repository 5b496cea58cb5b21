"""DVB-T2 mode parameter derivation (ETSI EN 302 755).

A re-design of the reference's mode math
(`/root/reference/src/DVB_T2/dvbt2_definition.{h,cpp}`): instead of a mutable
struct filled in by three init functions, a frozen dataclass derived once from
the transmission mode.  Everything downstream (pilot maps, interleaver address
tables, framing) is a pure function of this object, so it can be hashed and
used as a static argument to jitted functions.

Parity with reference:
  - n_p2 / c_p2 per FFT mode & SISO/MISO: dvbt2_definition.cpp:20-91
  - fft_size / k_total / k_ext / k_offset: dvbt2_definition.cpp:93-159
  - c_data / n_fc / c_fc per FFT x PP x carrier-mode (+ TR-PAPR reduction,
    GI legality zeroing of the frame-closing symbol): dvbt2_definition.cpp:161-648
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from fractions import Fraction

# 8 MHz bandwidth elementary period (dvbt2_definition.h:29-31)
T_PERIOD = 7.0 / 64.0 * 1e-6
SAMPLE_RATE = 1.0 / T_PERIOD  # 9.142857.. Msps


class Bandwidth(enum.Enum):
    """Channel bandwidths with their elementary periods T (EN 302 755's
    per-bandwidth elementary-period table; T in us as a rational, e.g.
    7/64 us for 8 MHz, 71/131 us for 1.7 MHz).  The reference application
    is hardwired to the 8 MHz rate (dvbt2_definition.h:29-31); here every
    bandwidth the standard defines is a first-class mode.  The sample-domain
    structure (carriers, GI, frame lengths in elementary periods) is
    bandwidth-invariant — only the seconds<->samples scale changes, so the
    bandwidth enters exclusively through `sample_rate` at the Hz boundaries
    (CFO reporting, device retunes, front-end resampling)."""
    BW_1_7 = (71, 131)   # T2-Lite mobile/audio channels
    BW_5 = (7, 40)
    BW_6 = (7, 48)
    BW_7 = (7, 56)
    BW_8 = (7, 64)
    BW_10 = (7, 80)      # professional/non-broadcast use

    @property
    def t_period(self) -> float:
        num, den = self.value
        return num / den * 1e-6

    @property
    def sample_rate(self) -> float:
        num, den = self.value
        return den / num * 1e6

    @property
    def mhz(self) -> float:
        return {"BW_1_7": 1.7, "BW_5": 5.0, "BW_6": 6.0, "BW_7": 7.0,
                "BW_8": 8.0, "BW_10": 10.0}[self.name]

    @classmethod
    def from_mhz(cls, mhz: float) -> "Bandwidth":
        for bw in cls:
            if abs(bw.mhz - mhz) < 0.05:
                return bw
        raise ValueError(f"no DVB-T2 bandwidth {mhz} MHz "
                         f"(valid: 1.7, 5, 6, 7, 8, 10)")

    @classmethod
    def from_rate(cls, fs: float) -> "Bandwidth | None":
        """Nearest bandwidth whose elementary rate matches `fs` (None if
        no standard bandwidth is within 1%)."""
        for bw in cls:
            if abs(bw.sample_rate - fs) <= 0.01 * bw.sample_rate:
                return bw
        return None

FEC_SIZE_NORMAL = 64800
FEC_SIZE_SHORT = 16200
L1_PRE_CELL = 1840
CHIPS = 2624  # frame-level PN sequence length


class FFTMode(enum.IntEnum):
    """FFT sizes; values match the S2 field-1 coding used on-air (and the
    reference's dvbt2_fft_mode_t) so L1/P1 parsing is a cast."""
    FFT_2K = 0
    FFT_8K = 1
    FFT_4K = 2
    FFT_1K = 3
    FFT_16K = 4
    FFT_32K = 5
    FFT_8K_T2GI = 6
    FFT_32K_T2GI = 7
    FFT_16K_T2GI = 11


class GuardInterval(enum.IntEnum):
    """Guard intervals; values match the L1-pre GUARD_INTERVAL field."""
    GI_1_32 = 0
    GI_1_16 = 1
    GI_1_8 = 2
    GI_1_4 = 3
    GI_1_128 = 4
    GI_19_128 = 5
    GI_19_256 = 6

    @property
    def fraction(self) -> Fraction:
        return {
            GuardInterval.GI_1_32: Fraction(1, 32),
            GuardInterval.GI_1_16: Fraction(1, 16),
            GuardInterval.GI_1_8: Fraction(1, 8),
            GuardInterval.GI_1_4: Fraction(1, 4),
            GuardInterval.GI_1_128: Fraction(1, 128),
            GuardInterval.GI_19_128: Fraction(19, 128),
            GuardInterval.GI_19_256: Fraction(19, 256),
        }[self]


class PilotPattern(enum.IntEnum):
    PP1 = 0
    PP2 = 1
    PP3 = 2
    PP4 = 3
    PP5 = 4
    PP6 = 5
    PP7 = 6
    PP8 = 7


class Constellation(enum.IntEnum):
    QPSK = 0
    QAM16 = 1
    QAM64 = 2
    QAM256 = 3

    @property
    def bits_per_cell(self) -> int:
        return {self.QPSK: 2, self.QAM16: 4, self.QAM64: 6, self.QAM256: 8}[self]


class CodeRate(enum.IntEnum):
    C1_2 = 0
    C3_5 = 1
    C2_3 = 2
    C3_4 = 3
    C4_5 = 4
    C5_6 = 5
    C1_4 = 6  # short-frame only (L1 signalling)


class FECFrame(enum.IntEnum):
    SHORT = 0
    NORMAL = 1


class PAPR(enum.IntEnum):
    OFF = 0
    ACE = 1
    TR = 2
    BOTH = 3


class Preamble(enum.IntEnum):
    T2_SISO = 0
    T2_MISO = 1
    NON_T2 = 2
    T2_LITE_SISO = 3
    T2_LITE_MISO = 4


# --- P1 S2 field 1 coding (EN 302 755 table 49) -----------------------------
# The 3-bit S2 field 1 announces the FFT size (and which guard-interval SET
# to expect) and is interpreted per the S1 profile: the base-T2 column is
# table 16/49's familiar eight codes; for T2-LITE preambles (S1 = 3/4) the
# codes are reassigned because annex I drops 1K and 32K — code 3 (1K in
# base) becomes 16K with the T2-GI guard set, and the 32K codes are
# reserved.  Provenance: the base column is cross-checked against the
# reference's S2 handling (p1_symbol.cpp:233-284); the lite column is
# reconstructed from the spec's field descriptions (no EN 302 755 text is
# available in this environment) and pinned by an independent
# transcription in tests/test_t2lite.py — disclosed like the L1
# puncture-order provenance in dvbt2/l1.py.
_S2_FIELD1_BASE = {
    FFTMode.FFT_2K: 0, FFTMode.FFT_8K: 1, FFTMode.FFT_4K: 2,
    FFTMode.FFT_1K: 3, FFTMode.FFT_16K: 4, FFTMode.FFT_32K: 5,
    FFTMode.FFT_8K_T2GI: 6, FFTMode.FFT_32K_T2GI: 7,
    # no separate 16K T2-GI code in the base column ('100' covers 16K
    # with every guard set)
    FFTMode.FFT_16K_T2GI: 4,
}
_S2_FIELD1_LITE = {
    FFTMode.FFT_2K: 0, FFTMode.FFT_8K: 1, FFTMode.FFT_4K: 2,
    FFTMode.FFT_16K_T2GI: 3, FFTMode.FFT_16K: 4,
    FFTMode.FFT_8K_T2GI: 6,
}


def s2_field1_code(fft_mode: "FFTMode", preamble: "Preamble") -> int:
    """FFT mode -> P1 S2 field 1 (3 bits) for the transmission profile."""
    if preamble in (Preamble.T2_LITE_SISO, Preamble.T2_LITE_MISO):
        if fft_mode not in _S2_FIELD1_LITE:
            raise ValueError(f"{fft_mode.name} is not a T2-Lite FFT size "
                             f"(annex I allows 2K/4K/8K/16K)")
        return _S2_FIELD1_LITE[fft_mode]
    return _S2_FIELD1_BASE[fft_mode]


def fft_from_s2_field1(field1: int, lite: bool) -> "FFTMode | None":
    """P1 S2 field 1 -> FFT mode (None = reserved for that profile)."""
    if lite:
        inv = {0: FFTMode.FFT_2K, 1: FFTMode.FFT_8K, 2: FFTMode.FFT_4K,
               3: FFTMode.FFT_16K_T2GI, 4: FFTMode.FFT_16K,
               6: FFTMode.FFT_8K_T2GI}
    else:
        inv = {0: FFTMode.FFT_2K, 1: FFTMode.FFT_8K, 2: FFTMode.FFT_4K,
               3: FFTMode.FFT_1K, 4: FFTMode.FFT_16K, 5: FFTMode.FFT_32K,
               6: FFTMode.FFT_8K_T2GI, 7: FFTMode.FFT_32K_T2GI}
    return inv.get(int(field1))


# (n_p2, c_p2) per FFT mode: {fft_size: (n_p2, c_p2_siso, c_p2_miso)}
_P2_PARAMS = {
    1024: (16, 558, 546),
    2048: (8, 1118, 1098),
    4096: (4, 2236, 2198),
    8192: (2, 4472, 4398),
    16384: (1, 8944, 8814),
    32768: (1, 22432, 17612),
}

# k_total/k_ext/k_offset: {fft_size: ((normal_k_total, k_offset), (ext_k_total, k_ext))}
_CARRIER_PARAMS = {
    1024: ((853, 0), (853, 0)),
    2048: ((1705, 0), (1705, 0)),
    4096: ((3409, 0), (3409, 0)),
    8192: ((6817, 48), (6913, 48)),
    16384: ((13633, 144), (13921, 144)),
    32768: ((27265, 288), (27841, 288)),
}

# (c_data, n_fc, c_fc) per fft_size x carrier-mode x pilot pattern.
# dvbt2_definition.cpp:161-648; 0 = combination not allowed.
_DATA_PARAMS = {
    1024: {
        False: {0: (764, 568, 402), 1: (768, 710, 654), 2: (798, 710, 490),
                3: (804, 780, 707), 4: (818, 780, 544)},
    },
    2048: {
        False: {0: (1522, 1136, 804), 1: (1532, 1420, 1309), 2: (1596, 1420, 980),
                3: (1602, 1562, 1415), 4: (1632, 1562, 1088), 6: (1646, 1632, 1396)},
    },
    4096: {
        False: {0: (3084, 2272, 1609), 1: (3092, 2840, 2619), 2: (3228, 2840, 1961),
                3: (3234, 3124, 2831), 4: (3298, 3124, 2177), 6: (3328, 3266, 2792)},
    },
    8192: {
        False: {0: (6208, 4544, 3218), 1: (6214, 5680, 5238), 2: (6494, 5680, 3922),
                3: (6498, 6248, 5662), 4: (6634, 6248, 4354), 6: (6698, 6532, 5585),
                7: (6698, 0, 0)},
        True: {0: (6296, 4608, 3264), 1: (6298, 5760, 5312), 2: (6584, 5760, 3978),
               3: (6588, 6336, 5742), 4: (6728, 6336, 4416), 6: (6788, 6624, 5664),
               7: (6788, 0, 0)},
    },
    16384: {
        False: {0: (12418, 9088, 6437), 1: (12436, 11360, 10476), 2: (12988, 11360, 7845),
                3: (13002, 12496, 11324), 4: (13272, 12496, 8709), 5: (13288, 13064, 11801),
                6: (13416, 13064, 11170), 7: (13406, 0, 0)},
        True: {0: (12678, 9280, 6573), 1: (12698, 11600, 10697), 2: (13262, 11600, 8011),
               3: (13276, 12760, 11563), 4: (13552, 12760, 8893), 5: (13568, 13340, 12051),
               6: (13698, 13340, 11406), 7: (13688, 0, 0)},
    },
    32768: {
        False: {1: (24886, 22720, 20952), 3: (26022, 24992, 22649),
                5: (26592, 26128, 23603), 6: (26836, 0, 0), 7: (26812, 0, 0)},
        True: {1: (25412, 23200, 21395), 3: (26572, 25520, 23127),
               5: (27152, 26680, 24102), 6: (27404, 0, 0), 7: (27376, 0, 0)},
    },
}

# number of TR-PAPR reserved carriers per fft_size
_TR_CELLS = {1024: 10, 2048: 18, 4096: 36, 8192: 72, 16384: 144, 32768: 288}

_FFT_SIZE = {
    FFTMode.FFT_1K: 1024, FFTMode.FFT_2K: 2048, FFTMode.FFT_4K: 4096,
    FFTMode.FFT_8K: 8192, FFTMode.FFT_8K_T2GI: 8192,
    FFTMode.FFT_16K: 16384, FFTMode.FFT_16K_T2GI: 16384,
    FFTMode.FFT_32K: 32768, FFTMode.FFT_32K_T2GI: 32768,
}

# scattered pilot (dx, dy) per pilot pattern (clause 9.2.3.1)
SP_PATTERN = {
    PilotPattern.PP1: (3, 4), PilotPattern.PP2: (6, 2), PilotPattern.PP3: (6, 4),
    PilotPattern.PP4: (12, 2), PilotPattern.PP5: (12, 4), PilotPattern.PP6: (24, 2),
    PilotPattern.PP7: (24, 4), PilotPattern.PP8: (6, 16),
}

# scattered pilot amplitude per pattern (clause 9.2.3.1 table 35)
SP_AMPLITUDE = {
    PilotPattern.PP1: 4.0 / 3.0, PilotPattern.PP2: 4.0 / 3.0,
    PilotPattern.PP3: 7.0 / 4.0, PilotPattern.PP4: 7.0 / 4.0,
    PilotPattern.PP5: 7.0 / 3.0, PilotPattern.PP6: 7.0 / 3.0,
    PilotPattern.PP7: 7.0 / 3.0, PilotPattern.PP8: 7.0 / 3.0,
}


def cp_amplitude(fft_size: int) -> float:
    """Continual pilot amplitude (clause 9.2.3.2.2)."""
    if fft_size <= 2048:
        return 4.0 / 3.0
    if fft_size == 4096:
        return 4.0 * (2.0 ** 0.5) / 3.0
    return 8.0 / 3.0


def p2_amplitude(fft_size: int, miso: bool) -> float:
    """P2 pilot amplitude (clause 9.2.3.3.2)."""
    if fft_size == 32768 and not miso:
        return 37.0 ** 0.5 / 5.0
    return 31.0 ** 0.5 / 5.0


@dataclass(frozen=True)
class T2Params:
    """Frozen transmission-mode parameters; hashable (usable as jit static arg)."""
    fft_mode: FFTMode = FFTMode.FFT_32K
    guard: GuardInterval = GuardInterval.GI_1_128
    pilot_pattern: PilotPattern = PilotPattern.PP7
    extended_carrier: bool = True
    papr: PAPR = PAPR.OFF
    miso: bool = False
    miso_group: int = 0
    n_data: int = 59  # data symbols per frame excl. P1/P2
    preamble: Preamble = Preamble.T2_SISO
    # FEF parts (clause 8.4): (fef_type, fef_length, fef_interval) or None.
    # fef_length in elementary periods incl. the FEF P1; a FEF part follows
    # every T2-frame whose (FRAME_IDX+1) mod FEF_INTERVAL == 0.  The
    # reference receiver does not support FEF at all; here both the
    # modulator and the receivers schedule around them.
    fef: tuple | None = None
    # Channel bandwidth: sets the elementary period only (the sample-domain
    # mode structure is bandwidth-invariant).  Not signalled on-air — the
    # tuner's channel raster determines it, so receivers take it as an
    # input-side declaration (t2rx --bandwidth).
    bandwidth: Bandwidth = Bandwidth.BW_8

    @property
    def sample_rate(self) -> float:
        """Elementary sample rate in Hz for this mode's bandwidth."""
        return self.bandwidth.sample_rate

    def fef_after(self, frame_idx: int) -> int:
        """Elementary periods of FEF part following T2-frame `frame_idx`
        (0 when none)."""
        if self.fef is None or self.fef[2] <= 0:
            return 0
        return int(self.fef[1]) if (frame_idx + 1) % self.fef[2] == 0 else 0

    # --- derived, all properties so the dataclass stays tiny/hashable ---
    @property
    def fft_size(self) -> int:
        return _FFT_SIZE[self.fft_mode]

    @property
    def n_p2(self) -> int:
        return _P2_PARAMS[self.fft_size][0]

    @property
    def c_p2(self) -> int:
        n, siso, miso = _P2_PARAMS[self.fft_size]
        return miso if self.miso else siso

    @property
    def k_total(self) -> int:
        norm, ext = _CARRIER_PARAMS[self.fft_size]
        return (ext if self.extended_carrier else norm)[0]

    @property
    def k_ext(self) -> int:
        """Carriers added each side in extended mode (0 when normal)."""
        return _CARRIER_PARAMS[self.fft_size][1][1] if self.extended_carrier else 0

    @property
    def k_offset(self) -> int:
        """PRBS index offset in normal-carrier mode."""
        return 0 if self.extended_carrier else _CARRIER_PARAMS[self.fft_size][0][1]

    @property
    def left_nulls(self) -> int:
        """Index of carrier 0 in the fft-shifted spectrum (l_nulls)."""
        return (self.fft_size - self.k_total) // 2 + 1

    def _data_triple(self):
        per_fft = _DATA_PARAMS[self.fft_size]
        table = per_fft.get(self.extended_carrier, per_fft[False])
        pp = int(self.pilot_pattern)
        if pp not in table:
            raise ValueError(
                f"pilot pattern {self.pilot_pattern!r} not allowed for fft {self.fft_size}")
        c_data, n_fc, c_fc = table[pp]
        if self.papr in (PAPR.TR, PAPR.BOTH):
            tr = _TR_CELLS[self.fft_size]
            c_data = c_data - tr if c_data else 0
            n_fc = n_fc - tr if n_fc else 0
            c_fc = c_fc - tr if c_fc else 0
        # GI/PP combos whose frame-closing symbol is not transmitted (SISO)
        if not self.miso:
            bad = {
                (GuardInterval.GI_1_128, PilotPattern.PP7),
                (GuardInterval.GI_1_32, PilotPattern.PP4),
                (GuardInterval.GI_1_16, PilotPattern.PP2),
                (GuardInterval.GI_19_256, PilotPattern.PP2),
            }
            if (self.guard, self.pilot_pattern) in bad:
                n_fc, c_fc = 0, 0
        return c_data, n_fc, c_fc

    @property
    def c_data(self) -> int:
        return self._data_triple()[0]

    @property
    def n_fc(self) -> int:
        """Data cells in the frame-closing symbol."""
        return self._data_triple()[1]

    @property
    def c_fc(self) -> int:
        """Active (non-padded) data cells in the frame-closing symbol."""
        return self._data_triple()[2]

    @property
    def has_fc(self) -> bool:
        return self.n_fc != 0

    @property
    def guard_size(self) -> int:
        return int(self.fft_size * self.guard.fraction)

    @property
    def symbol_size(self) -> int:
        return self.fft_size + self.guard_size

    @property
    def len_frame(self) -> int:
        """OFDM symbols per T2-frame excluding P1."""
        return self.n_p2 + self.n_data

    @property
    def frame_samples(self) -> int:
        """Total samples per T2-frame including the P1 preamble."""
        return 2048 + self.len_frame * self.symbol_size

    @property
    def cells_per_frame(self) -> int:
        """Total active data cells per T2-frame (P2 + data + FC)."""
        n_plain_data = self.n_data - (1 if self.has_fc else 0)
        return self.n_p2 * self.c_p2 + n_plain_data * self.c_data + self.n_fc

    def with_(self, **kw) -> "T2Params":
        return replace(self, **kw)


# --- FEC parameters (clause 6.1, tables 6a/6b of EN 302 755) ---

@dataclass(frozen=True)
class FECParams:
    frame: FECFrame
    rate: CodeRate
    n_ldpc: int
    k_ldpc: int
    k_bch: int
    q_ldpc: int

    @property
    def n_bch(self) -> int:
        return self.k_ldpc

    @property
    def bch_parity(self) -> int:
        return self.k_ldpc - self.k_bch

    @property
    def t_bch(self) -> int:
        """BCH error-correcting capability (table 6a/6b): parity / field bits."""
        return self.bch_parity // (16 if self.frame == FECFrame.NORMAL else 14)


_FEC_NORMAL = {
    CodeRate.C1_2: (32400, 32208, 90),
    CodeRate.C3_5: (38880, 38688, 72),
    CodeRate.C2_3: (43200, 43040, 60),
    CodeRate.C3_4: (48600, 48408, 45),
    CodeRate.C4_5: (51840, 51648, 36),
    CodeRate.C5_6: (54000, 53840, 30),
}
# short-frame effective rates (table 6b); C1_4 used by L1-pre
_FEC_SHORT = {
    CodeRate.C1_4: (3240, 3072, 36),
    CodeRate.C1_2: (7200, 7032, 25),
    CodeRate.C3_5: (9720, 9552, 18),
    CodeRate.C2_3: (10800, 10632, 15),
    CodeRate.C3_4: (11880, 11712, 12),
    CodeRate.C4_5: (12600, 12432, 10),
    CodeRate.C5_6: (13320, 13152, 8),
}


def fec_params(frame: FECFrame, rate: CodeRate) -> FECParams:
    table = _FEC_NORMAL if frame == FECFrame.NORMAL else _FEC_SHORT
    n_ldpc = FEC_SIZE_NORMAL if frame == FECFrame.NORMAL else FEC_SIZE_SHORT
    k_ldpc, k_bch, q_ldpc = table[rate]
    return FECParams(frame=frame, rate=rate, n_ldpc=n_ldpc, k_ldpc=k_ldpc,
                     k_bch=k_bch, q_ldpc=q_ldpc)


@dataclass(frozen=True)
class PLPParams:
    """Per-PLP modulation/coding config (subset of L1-post PLP loop)."""
    plp_id: int = 0
    constellation: Constellation = Constellation.QAM256
    rate: CodeRate = CodeRate.C2_3
    fec_frame: FECFrame = FECFrame.NORMAL
    rotated: bool = True
    num_blocks_max: int = 8     # PLP_NUM_BLOCKS_MAX
    time_il_length: int = 3     # N_TI when time_il_type==0
    time_il_type: int = 0
    frame_interval: int = 1     # I_JUMP
    first_frame_idx: int = 0
    plp_type: int = 1           # 1 = contiguous slice, 2 = sub-sliced
    sub_slices: int = 1         # SUB_SLICES_PER_FRAME (type 2 only)
    in_band_a: bool = False     # IN_BAND_A_FLAG (clause 5.2.3 payload)

    @property
    def fec(self) -> FECParams:
        return fec_params(self.fec_frame, self.rate)

    @property
    def bits_per_cell(self) -> int:
        return self.constellation.bits_per_cell

    @property
    def cells_per_fec_block(self) -> int:
        return self.fec.n_ldpc // self.bits_per_cell

    @property
    def n_split(self) -> int:
        """Columns per FEC block in the time interleaver (always 5)."""
        return 5

    @property
    def ti_rows(self) -> int:
        return self.cells_per_fec_block // self.n_split
