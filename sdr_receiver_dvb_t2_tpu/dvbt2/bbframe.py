"""BB-frame layer (ETSI EN 302 755 clause 5.1): mode adaptation, BB header
CRC-8, BB scrambling, and TS packet-stream reassembly.

Both directions are implemented so the TX side (`ts_to_bbframes`) can feed any
standard receiver and the RX side (`TSAssembler`) reproduces the reference
receiver's TS reconstruction semantics (`bb_de_header.cpp:84-448`):
  - mode detection via the CRC-8 residual of the 80-bit header
    (clause 5.1.7 MODE bit XORed onto the CRC byte; NM vs HEM)
  - NM: each user packet's sync byte is replaced by the CRC-8 of the
    *previous* packet's 187 payload bytes; mismatch sets the TS
    transport-error-indicator bit on the affected packet
    (bb_de_header.cpp:219,237-239)
  - HEM: sync bytes re-inserted at every 188-byte boundary, no per-packet CRC
  - resynchronization via SYNCD with 0xF0 fill of a truncated packet
    (bb_de_header.cpp:356-385)

Bit-level work is vectorized NumPy on packed arrays; the per-frame pointer
walk is host Python (kilobytes per frame, not a bottleneck -- SURVEY.md §7).
The descrambler PRBS is precomputed once and applied as a single XOR, which
on-device is one fused elementwise op over the whole codeword batch.
"""
from __future__ import annotations

import bisect
import functools
from dataclasses import dataclass, field

import numpy as np

TS_PACKET = 188
TS_SYNC = 0x47
BB_HEADER_BITS = 80
MAX_KBCH = 53840  # largest k_bch (normal C5_6)


# --- CRC-8 (poly x^8+x^7+x^6+x^4+x^2+1 = 0xD5 MSB-first), per clause 5.1.4 ---

@functools.lru_cache(maxsize=None)
def _crc8_table() -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint8)
    for i in range(256):
        crc = 0
        for j in range(7, -1, -1):
            bit = (i >> j) & 1
            if bit ^ (crc >> 7):
                crc = ((crc << 1) ^ 0xD5) & 0xFF
            else:
                crc = (crc << 1) & 0xFF
        tab[i] = crc
    return tab


def crc8(data: np.ndarray) -> int:
    """CRC-8 over bytes (uint8 array), MSB-first, init 0."""
    tab = _crc8_table()
    crc = 0
    for b in np.asarray(data, dtype=np.uint8):
        crc = int(tab[crc ^ int(b)])
    return crc


def crc8_rows(rows: np.ndarray) -> np.ndarray:
    """CRC-8 of each row of a (n, m) uint8 array: the per-packet NM CRC
    check vectorized across packets (m table steps instead of n*m Python
    iterations); dispatches to the native kernel when built (one C loop,
    the AVX-class throughput the reference gets from bb_de_header.cpp)."""
    rows = np.asarray(rows, dtype=np.uint8)  # strided views: no copy
    from .. import native
    out = native.crc8_rows(rows)
    if out is not None:
        return out
    tab = _crc8_table()
    crc = np.zeros(rows.shape[0], dtype=np.uint8)
    for j in range(rows.shape[1]):
        crc = tab[crc ^ rows[:, j]]
    return crc


# --- BB scrambler (clause 5.2.4): PRBS x^15+x^14+1, init 100101010000000 ---

@functools.lru_cache(maxsize=None)
def bb_scrambler_sequence(length: int = MAX_KBCH) -> np.ndarray:
    """Scrambler bit sequence; XOR with BB-frame bits (both directions)."""
    out = np.empty(length, dtype=np.uint8)
    sr = 0x4A80
    for i in range(length):
        b = (sr ^ (sr >> 1)) & 1
        out[i] = b
        sr >>= 1
        if b:
            sr |= 0x4000
    return out


def scramble(frame_bits: np.ndarray) -> np.ndarray:
    """(De)scramble BB-frame bits ((..., kbch) uint8); involution."""
    seq = bb_scrambler_sequence(frame_bits.shape[-1])
    return np.bitwise_xor(frame_bits, seq)


# --- BB header ---

@dataclass
class BBHeader:
    """Parsed 80-bit BB header (clause 5.1.6/5.1.7)."""
    ts_gs: int = 0b11        # 11 = transport stream
    sis_mis: int = 1         # 1 = single input stream
    ccm_acm: int = 1         # 1 = CCM
    issyi: int = 0
    npd: int = 0
    ext: int = 0
    isi: int = 0             # input stream id (MIS only)
    upl: int = TS_PACKET * 8
    dfl: int = 0
    sync: int = TS_SYNC
    syncd: int = 0
    hem: bool = False

    def to_bits(self) -> np.ndarray:
        """Serialize to 80 bits incl. the mode-bearing CRC-8 byte."""
        bits = np.zeros(BB_HEADER_BITS, dtype=np.uint8)

        def put(value, start, width):
            for i in range(width):
                bits[start + i] = (value >> (width - 1 - i)) & 1

        put(self.ts_gs, 0, 2)
        put(self.sis_mis, 2, 1)
        put(self.ccm_acm, 3, 1)
        put(self.issyi, 4, 1)
        put(self.npd, 5, 1)
        put(self.ext, 6, 2)
        put(self.isi if self.sis_mis == 0 else 0, 8, 8)
        put(self.upl, 16, 16)
        put(self.dfl, 32, 16)
        put(self.sync, 48, 8)
        put(self.syncd, 56, 16)
        c = crc8(np.packbits(bits[:72]))
        if self.hem:
            c ^= 1  # MODE bit (clause 5.1.7) marks high-efficiency mode
        put(c, 72, 8)
        return bits

    @classmethod
    def from_bits(cls, bits: np.ndarray) -> "BBHeader | None":
        """Parse 80 header bits; None when the CRC residual matches neither
        mode (reference: bb_de_header.cpp:101-113)."""
        bits = np.asarray(bits[:BB_HEADER_BITS], dtype=np.uint8)

        def get(start, width):
            v = 0
            for i in range(width):
                v = (v << 1) | int(bits[start + i])
            return v

        received = get(72, 8)
        expect = crc8(np.packbits(bits[:72]))
        if received == expect:
            hem = False
        elif received == expect ^ 1:
            hem = True
        else:
            return None
        sis_mis = get(2, 1)
        return cls(ts_gs=get(0, 2), sis_mis=sis_mis, ccm_acm=get(3, 1),
                   issyi=get(4, 1), npd=get(5, 1), ext=get(6, 2),
                   isi=get(8, 8) if sis_mis == 0 else 0,
                   upl=get(16, 16), dfl=get(32, 16), sync=get(48, 8),
                   syncd=get(56, 16), hem=hem)

    @classmethod
    def from_bytes(cls, by: np.ndarray) -> "BBHeader | None":
        """Parse the 10-byte BB header (all fields are byte-aligned); the
        fast entry used by `TSAssembler.push_bytes`."""
        by = np.asarray(by[:10], dtype=np.uint8)
        received = int(by[9])
        expect = crc8(by[:9])
        if received == expect:
            hem = False
        elif received == expect ^ 1:
            hem = True
        else:
            return None
        b0 = int(by[0])
        sis_mis = (b0 >> 5) & 1
        return cls(ts_gs=b0 >> 6, sis_mis=sis_mis, ccm_acm=(b0 >> 4) & 1,
                   issyi=(b0 >> 3) & 1, npd=(b0 >> 2) & 1, ext=b0 & 3,
                   isi=int(by[1]) if sis_mis == 0 else 0,
                   upl=(int(by[2]) << 8) | int(by[3]),
                   dfl=(int(by[4]) << 8) | int(by[5]), sync=int(by[6]),
                   syncd=(int(by[7]) << 8) | int(by[8]), hem=hem)


# --- TX: TS -> BB frames (mode + stream adaptation) ---

@dataclass
class ModeAdapter:
    """Stateful TS -> BB-frame segmenter for one PLP.

    The user-packet (UP) stream: NM keeps 188 bytes per packet with the sync
    byte replaced by the CRC-8 of the previous packet's 187 payload bytes
    (clause 5.1.4); HEM drops the sync byte (187 bytes per UP).
    """
    kbch: int
    hem: bool = False
    isi: int = 0
    sis_mis: int = 1
    _stream: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    _crc_prev: int = 0
    _stream_pos: int = 0  # total UP-stream bytes already emitted in BB frames

    @property
    def up_size(self) -> int:
        return TS_PACKET - (1 if self.hem else 0)

    @property
    def dfl(self) -> int:
        return self.kbch - BB_HEADER_BITS

    def packets_needed(self, n_frames: int) -> int:
        """TS packets required before n_frames full BB frames can be emitted."""
        need = n_frames * (self.dfl // 8) - len(self._stream)
        return max(0, -(-need // self.up_size))

    def push_packets(self, ts: np.ndarray) -> None:
        """Append TS packets ((n,188) or flat bytes) to the pending stream."""
        ts = np.asarray(ts, dtype=np.uint8).reshape(-1, TS_PACKET)
        if not (ts[:, 0] == TS_SYNC).all():
            raise ValueError("TS packets must start with 0x47")
        chunks = [self._stream]
        for pkt in ts:
            if self.hem:
                chunks.append(pkt[1:])
            else:
                chunks.append(np.concatenate(
                    [np.array([self._crc_prev], np.uint8), pkt[1:]]))
                self._crc_prev = crc8(pkt[1:])
        self._stream = np.concatenate(chunks)

    def next_frame(self, padding_bits: np.ndarray | None = None) -> np.ndarray:
        """Emit one kbch-bit (unscrambled) BB frame; raises if starved.

        `padding_bits` (byte-aligned length), when given, occupy the padding
        field after the data field (clause 5.2.2) — the data field shrinks
        by that amount and DFL reflects it.  This is how in-band signalling
        rides the first BB frame of an Interleaving Frame (clause 5.2.3,
        `dvbt2.inband`)."""
        dfl = self.dfl
        pad = np.zeros(0, np.uint8)
        if padding_bits is not None:
            pad = np.asarray(padding_bits, dtype=np.uint8)
            if len(pad) % 8:
                raise ValueError("padding must be byte-aligned")
            dfl -= len(pad)
            if dfl <= 0:
                raise ValueError("padding exceeds the BB data field")
        dfl_bytes = dfl // 8
        if len(self._stream) < dfl_bytes:
            raise ValueError(
                f"need {dfl_bytes} stream bytes, have {len(self._stream)}; "
                "call push_packets first")
        data = self._stream[:dfl_bytes]
        self._stream = self._stream[dfl_bytes:]
        into_up = self._stream_pos % self.up_size
        syncd_bytes = (self.up_size - into_up) % self.up_size
        syncd = syncd_bytes * 8 if syncd_bytes < dfl_bytes else 0xFFFF
        self._stream_pos += dfl_bytes
        hdr = BBHeader(hem=self.hem, dfl=dfl, syncd=syncd,
                       isi=self.isi, sis_mis=self.sis_mis,
                       upl=TS_PACKET * 8 if not self.hem else 0,
                       sync=TS_SYNC if not self.hem else 0)
        frame = np.concatenate([hdr.to_bits(), np.unpackbits(data), pad])
        assert frame.shape[0] == self.kbch
        return frame


def ts_to_bbframes(ts: np.ndarray, kbch: int, n_frames: int,
                   hem: bool = False) -> np.ndarray:
    """Convenience: segment TS bytes into (n_frames, kbch) unscrambled
    BB frames. Raises when `ts` has too few packets."""
    adapter = ModeAdapter(kbch=kbch, hem=hem)
    adapter.push_packets(ts)
    return np.stack([adapter.next_frame() for _ in range(n_frames)])


# --- RX: BB frames -> TS ---

class PacketList:
    """Chronological TS-packet store over CHUNKED (n, 188) row blocks.

    Presents the list-of-(188,)-arrays interface the assembler's
    consumers use — len() = packet count, [i] = mutable row view (the NM
    TEI back-mark writes through it), [a:b] = (k, 188) block for
    flushing — without materializing one Python object per packet: at
    bench rate (~4k packets/frame) the per-row-view overhead of
    list.extend was the single largest host-tail cost."""
    __slots__ = ("_blocks", "_starts", "_n")

    def __init__(self):
        self._blocks: list[np.ndarray] = []
        self._starts: list[int] = []
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append(self, pkt: np.ndarray) -> None:
        self.extend(np.asarray(pkt, np.uint8).reshape(1, -1))

    def extend(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, np.uint8)
        if rows.ndim == 1:
            rows = rows.reshape(1, -1)
        if rows.shape[0] == 0:
            return
        self._blocks.append(rows)
        self._starts.append(self._n)
        self._n += rows.shape[0]

    def _locate(self, i: int) -> tuple[int, int]:
        b = bisect.bisect_right(self._starts, i) - 1
        return b, i - self._starts[b]

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self._n)
            if step != 1:
                raise IndexError("PacketList slices are contiguous")
            if start >= stop:
                return np.zeros((0, TS_PACKET), np.uint8)
            b0, r0 = self._locate(start)
            b1, r1 = self._locate(stop - 1)
            if b0 == b1:
                return self._blocks[b0][r0:r1 + 1]
            parts = ([self._blocks[b0][r0:]]
                     + self._blocks[b0 + 1:b1]
                     + [self._blocks[b1][:r1 + 1]])
            return np.concatenate(parts, axis=0)
        i = int(idx)
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        b, r = self._locate(i)
        return self._blocks[b][r]

    def __iter__(self):
        for blk in self._blocks:
            yield from blk

    def tobytes_flat(self) -> np.ndarray:
        if self._n == 0:
            return np.zeros(0, np.uint8)
        if len(self._blocks) == 1:
            return self._blocks[0].reshape(-1)
        return np.concatenate(self._blocks, axis=0).reshape(-1)


@dataclass
class TSAssembler:
    """Stateful BB-frame -> TS reassembler mirroring bb_de_header.cpp.

    Feed descrambled BB frames via `push`; 188-byte TS packets accumulate in
    `packets` with sync bytes restored.  NM per-packet CRC mismatches set the
    transport-error-indicator bit (0x80 of byte 1) on the affected packet.
    After a bad header or a SYNCD mismatch the assembler flushes the partial
    packet 0xF0-padded with TEI set and re-locks at the frame's SYNCD.
    """
    packets: PacketList = field(default_factory=PacketList)
    errors: int = 0        # NM CRC mismatches / truncated packets
    bad_headers: int = 0
    resyncs: int = 0
    hem: bool | None = None        # detected from the first good header
    _buf: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    _prev_crc: int | None = None   # expected replaced-sync byte; None=unknown
    _lost: bool = True             # not yet locked to a UP boundary
    _subs: dict = field(default_factory=dict)   # plp_id -> sub-assembler
    _last_idx: int | None = None   # index of OUR newest packet in `packets`

    def stream(self, key) -> "TSAssembler":
        """Per-PLP sub-assembler: each PLP is an independent TS byte
        stream (clause 5.1) — pushing two PLPs' BB frames through ONE
        framer corrupts the UP/SYNCD chain of both.  The sub shares the
        parent's `packets` list (a chronological remux, what the
        single-TS sink consumes) but keeps its OWN framing state
        (_buf/_prev_crc/_lost/hem).  key=None returns the parent itself
        (the single-PLP fast path).  Counters stay per-sub; read
        aggregate totals via error_count()/packet_count() on the parent.
        Mirrors the reference's per-PLP bb_de_header instances
        (dvbt2_demodulator.cpp: one decode chain per selected PLP)."""
        if key is None:
            return self
        a = self._subs.get(key)
        if a is None:
            a = TSAssembler()
            a.packets = self.packets
            self._subs[key] = a
        return a

    def flush_safe_count(self) -> int:
        """Leading packets that can no longer be amended and are safe to
        flush to a sink.  Each (sub-)assembler's NEWEST packet may still
        receive a TEI back-mark when the next frame's CRC byte arrives
        (NM mode, see push:461) — in multi-PLP streaming every sub shares
        the parent's `packets` list, so holding back only the single
        globally-newest packet would let a sub amend an already-flushed
        copy."""
        idxs = [a._last_idx
                for a in [self, *self._subs.values()]
                if a._last_idx is not None]
        return min(idxs) if idxs else len(self.packets)

    def error_count(self) -> int:
        return self.errors + sum(a.errors for a in self._subs.values())

    def resync_count(self) -> int:
        return self.resyncs + sum(a.resyncs for a in self._subs.values())

    def push(self, frame_bits: np.ndarray) -> None:
        self.push_bytes(np.packbits(np.asarray(frame_bits, np.uint8)))

    def push_frames(self, rows: np.ndarray) -> None:
        """Batched push of a whole T2-frame's BB frames ((B, kbch//8)
        descrambled bytes): when every header is clean, the mode uniform,
        and the SYNCD chain consistent (the steady state), ALL data fields
        are concatenated and drained in ONE vectorized pass — one
        crc8_rows over the frame's ~thousands of packets instead of B
        small ones.  Any irregularity falls back to the per-BB-frame path
        (identical semantics)."""
        rows = np.asarray(rows, dtype=np.uint8)
        heads = rows[:, :10]
        crcs = crc8_rows(heads[:, :9])
        rcv = heads[:, 9]
        hem_all = bool((rcv == crcs ^ 1).all())
        nm_all = bool((rcv == crcs).all())
        if not (hem_all or nm_all):
            for r in rows:
                self.push_bytes(r)
            return
        hem = hem_all
        up = TS_PACKET - (1 if hem else 0)
        dfl = (heads[:, 4].astype(np.int64) << 8) | heads[:, 5]
        dfl0 = int(dfl[0])
        syncd = (heads[:, 7].astype(np.int64) << 8) | heads[:, 8]
        if not (dfl == dfl0).all():
            # a leading in-band-signalling frame has a shorter data field
            # (clause 5.2.3): drain it alone, batch the uniform remainder
            if rows.shape[0] > 1 and (dfl[1:] == dfl[1]).all():
                self.push_bytes(rows[0])
                self.push_frames(rows[1:])
            else:
                for r in rows:
                    self.push_bytes(r)
            return
        if (dfl0 % 8 or dfl0 // 8 > rows.shape[1] - 10
                or (syncd == 0xFFFF).any()):
            for r in rows:
                self.push_bytes(r)
            return
        if self._lost:
            # lock onto the first frame's SYNCD, then batch the rest
            self.push_bytes(rows[0])
            if self._lost or len(rows) == 1:
                for r in rows[1:]:
                    self.push_bytes(r)
                return
            self.push_frames(rows[1:])
            return
        # SYNCD chain consistency across the batch
        dflb = dfl0 // 8
        pos = len(self._buf)
        for sd in syncd:
            if int(sd) // 8 != (up - pos) % up:
                for r in rows:
                    self.push_bytes(r)
                return
            pos = (pos + dflb) % up
        buf = np.concatenate([self._buf,
                              rows[:, 10:10 + dflb].reshape(-1)])
        self.hem = hem
        n = len(buf) // up
        self._drain_ups(buf[:n * up].reshape(n, up), hem)
        self._buf = buf[n * up:]

    def push_bytes(self, frame_bytes: np.ndarray) -> None:
        """Byte-level entry (the device path emits descrambled BB bytes
        directly, ops/fec_device.make_bb_bytes_nb); the whole-UP drain is
        vectorized across the frame's packets so the host tail keeps up
        with the device superstep rate."""
        by = np.asarray(frame_bytes, dtype=np.uint8)
        hdr = BBHeader.from_bytes(by)
        if hdr is None or hdr.dfl % 8 or hdr.dfl // 8 > len(by) - 10:
            self.bad_headers += 1
            self._flush_partial()
            self._lost = True
            return
        self.hem = hdr.hem
        up = TS_PACKET - (1 if hdr.hem else 0)
        dfl_bytes = hdr.dfl // 8
        data = by[10:10 + dfl_bytes]

        if hdr.syncd == 0xFFFF:
            expect_next = up - len(self._buf)
            if self._lost or expect_next <= dfl_bytes:
                # inconsistent: a UP boundary should have occurred
                self._flush_partial()
                self._lost = True
                return
            self._buf = np.concatenate([self._buf, data])
            return

        syncd_bytes = hdr.syncd // 8
        if self._lost or syncd_bytes != (up - len(self._buf)) % up:
            if not self._lost:
                self.resyncs += 1
            self._flush_partial()
            data = data[syncd_bytes:]
            self._prev_crc = None
            self._lost = False
        self._buf = np.concatenate([self._buf, data])

        # drain whole UPs, vectorized over the frame's packets
        n = len(self._buf) // up
        if n == 0:
            return
        self._drain_ups(self._buf[:n * up].reshape(n, up), hdr.hem)
        self._buf = self._buf[n * up:]

    def _drain_ups(self, ups: np.ndarray, hem: bool) -> None:
        """Emit whole user packets, vectorized.  NM per-packet CRC chain:
        packet i's replaced-sync byte is the CRC-8 of packet i-1's payload;
        a mismatch flags the COVERED (previous) packet
        (bb_de_header.cpp:219,237-239)."""
        n = ups.shape[0]
        if n == 0:
            return
        block = np.empty((n, TS_PACKET), np.uint8)
        block[:, 0] = TS_SYNC
        if hem:
            block[:, 1:] = ups
        else:
            crc_bytes = ups[:, 0]
            block[:, 1:] = ups[:, 1:]
            # CRC over the copied payload view (strided native kernel: no
            # second materialization of the 187-byte columns)
            crcs = crc8_rows(block[:, 1:])
            if (self._prev_crc is not None and self._last_idx is not None
                    and int(crc_bytes[0]) != self._prev_crc):
                self.errors += 1
                # OUR previous packet, not the shared list's tail (another
                # PLP's sub may have appended since)
                self.packets[self._last_idx][1] |= 0x80
            bad = np.nonzero(crc_bytes[1:] != crcs[:-1])[0]
            if len(bad):
                self.errors += len(bad)
                block[bad, 1] |= 0x80
            self._prev_crc = int(crcs[-1])
        self.packets.extend(block)
        self._last_idx = len(self.packets) - 1

    def _flush_partial(self) -> None:
        """Emit an interrupted packet 0xF0-padded with TEI set (the reference
        fills with 0xF0 and flags: bb_de_header.cpp:237-239,370-385)."""
        if len(self._buf) == 0:
            return
        payload = self._buf if self.hem else self._buf[1:]  # NM byte 0 = crc
        if len(payload) > 0:
            pkt = np.concatenate([np.array([TS_SYNC], np.uint8), payload])
            pad = np.full(TS_PACKET - len(pkt), 0xF0, np.uint8)
            pkt = np.concatenate([pkt, pad])
            pkt[1] |= 0x80
            self.errors += 1
            self.packets.append(pkt)
            self._last_idx = len(self.packets) - 1
        self._buf = np.zeros(0, np.uint8)
        self._prev_crc = None

    def ts_bytes(self) -> np.ndarray:
        return self.packets.tobytes_flat()
