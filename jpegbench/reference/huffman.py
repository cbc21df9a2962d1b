"""Frozen copy of ``tpujpeg_torch/huffman.py`` for the benchmark's plain reference.

Huffman table construction + host (pure-Python) entropy decoders.

Covers SURVEY.md §2.1 components 4 (table construction), 7 (baseline entropy
decoder), 8 (DC predictors), 9 (restart handling), 10 (progressive scan
decoding). Algorithms follow T.81 Annex C (canonical code construction),
§F.2.2 (sequential decode: DECODE / RECEIVE / EXTEND), and §G.2
(progressive: spectral selection, successive approximation, EOB runs).

This module is the *reference/oracle* implementation: slow, simple,
CPU-only. The production paths are the C host decoder
(tpujpeg/native/) and the Pallas wavefront decoder
(tpujpeg/kernels/wavefront.py), both validated against this one.

The flat 16-bit lookup tables built here (`HuffTable.lut_sym/lut_len`)
are shared with the device wavefront decoder: SURVEY.md §2.1 #4 — "host
builds flat lookup tables packed into arrays the Pallas decoder indexes".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bitstream import Frame, HuffSpec, JpegData, Scan, split_restart_segments
from .errors import JpegHuffmanError, JpegSyntaxError, JpegTruncatedError


@dataclasses.dataclass
class HuffTable:
    """Decode-ready Huffman table.

    lut_sym/lut_len: flat 65536-entry LUT indexed by the next 16 bits of
    the stream (MSB-first). lut_len[i] == 0 marks an invalid prefix.
    JPEG codes are at most 16 bits (T.81 §C.2) so one level suffices; the
    table is built once per DHT and reused across segments/images.
    """

    lut_sym: np.ndarray  # uint8[65536]
    lut_len: np.ndarray  # uint8[65536]

    @staticmethod
    def from_spec(spec: HuffSpec) -> "HuffTable":
        lut_sym = np.zeros(65536, dtype=np.uint8)
        lut_len = np.zeros(65536, dtype=np.uint8)
        code = 0
        vi = 0
        for length in range(1, 17):
            n = int(spec.counts[length - 1])
            for _ in range(n):
                if code >= (1 << length):
                    raise JpegSyntaxError("overfull Huffman table")
                sym = int(spec.values[vi])
                vi += 1
                lo = code << (16 - length)
                hi = lo + (1 << (16 - length))
                lut_sym[lo:hi] = sym
                lut_len[lo:hi] = length
                code += 1
            code <<= 1
        return HuffTable(lut_sym=lut_sym, lut_len=lut_len)


def build_tables(specs: Dict[Tuple[int, int], HuffSpec]) -> Dict[Tuple[int, int], HuffTable]:
    return {k: HuffTable.from_spec(v) for k, v in specs.items()}


class BitReader:
    """MSB-first bit reader over a destuffed entropy segment.

    Reads past end-of-data return 1-bits (mirroring libjpeg's behavior of
    padding with ones) but are tracked: `overrun()` is true if more than
    the trailing pad byte's worth of fabricated bits was *consumed*.
    """

    __slots__ = ("data", "n", "pos", "buf", "cnt", "pad_bits")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.pos = 0
        self.buf = 0
        self.cnt = 0
        self.pad_bits = 0

    def _fill(self, need: int) -> None:
        while self.cnt < need:
            if self.pos < self.n:
                b = self.data[self.pos]
                self.pos += 1
            else:
                b = 0xFF
                self.pad_bits += 8
            self.buf = ((self.buf << 8) | b) & 0xFFFFFFFFFFFF
            self.cnt += 8

    def peek16(self) -> int:
        self._fill(16)
        return (self.buf >> (self.cnt - 16)) & 0xFFFF

    def skip(self, nbits: int) -> None:
        self._fill(nbits)
        self.cnt -= nbits

    def receive(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        self._fill(nbits)
        self.cnt -= nbits
        return (self.buf >> self.cnt) & ((1 << nbits) - 1)

    def overrun(self) -> bool:
        # Bits still held in buf were filled but not consumed; only count
        # consumed fabricated bits.
        return self.pad_bits - min(self.pad_bits, self.cnt) > 0


def extend(v: int, t: int) -> int:
    """T.81 §F.2.2.1 EXTEND: map t received bits to a signed value."""
    if t == 0:
        return 0
    return v if v >= (1 << (t - 1)) else v - (1 << t) + 1


def decode_symbol(r: BitReader, tbl: HuffTable) -> int:
    idx = r.peek16()
    ln = int(tbl.lut_len[idx])
    if ln == 0:
        raise JpegHuffmanError("invalid Huffman code")
    r.skip(ln)
    return int(tbl.lut_sym[idx])


# ---------------------------------------------------------------------------
# Block-order enumeration
# ---------------------------------------------------------------------------


def interleaved_block_order(
    frame: Frame, scan: Scan
) -> List[Tuple[int, int, int]]:
    """Per-MCU block sequence for an interleaved scan: list of
    (scan_comp_pos, comp_index, block_index_into_padded_grid) — but block
    index depends on the MCU; this returns the *template* per MCU:
    (scan_comp_pos, comp_index, (v, h)) flattened in T.81 §A.2.3 order."""
    order: List[Tuple[int, int, Tuple[int, int]]] = []
    for sp, ci in enumerate(scan.comp_indices):
        c = frame.components[ci]
        for v in range(c.v):
            for h in range(c.h):
                order.append((sp, ci, (v, h)))
    return order  # type: ignore[return-value]


def mcu_block_index(frame: Frame, ci: int, mcu_x: int, mcu_y: int, v: int, h: int) -> int:
    c = frame.components[ci]
    row = mcu_y * c.v + v
    col = mcu_x * c.h + h
    return row * c.padded_wb + col


# ---------------------------------------------------------------------------
# Baseline (and progressive-DC-first) sequential decode
# ---------------------------------------------------------------------------


def _decode_block_baseline(
    r: BitReader,
    dc_tbl: HuffTable,
    ac_tbl: HuffTable,
    pred: List[int],
    sp: int,
    out_row: np.ndarray,
) -> None:
    """Decode one full 64-coefficient block (T.81 §F.2.2.1-F.2.2.4) into
    out_row (zigzag order)."""
    t = decode_symbol(r, dc_tbl)
    if t > 15:
        raise JpegHuffmanError("bad DC size")
    diff = extend(r.receive(t), t)
    pred[sp] += diff
    out_row[0] = pred[sp]
    k = 1
    while k < 64:
        rs = decode_symbol(r, ac_tbl)
        run, size = rs >> 4, rs & 0x0F
        if size == 0:
            if run == 15:
                k += 16  # ZRL
                continue
            break  # EOB
        k += run
        if k > 63:
            raise JpegHuffmanError("AC run past end of block")
        out_row[k] = extend(r.receive(size), size)
        k += 1


def decode_baseline_scan(
    jpeg: JpegData,
    scan: Scan,
    coeffs: List[np.ndarray],
    tables: Optional[Dict[Tuple[int, int], HuffTable]] = None,
) -> None:
    """Decode a full sequential scan into per-component coefficient
    arrays `coeffs[ci]` of shape [padded_hb*padded_wb, 64] (zigzag order).

    Restart segments are decoded independently with fresh DC predictors
    (T.81 §E.2.4), exactly the property the wavefront device decoder
    exploits for lane parallelism (SURVEY.md §3.4)."""
    frame = jpeg.frame
    if tables is None:
        tables = build_tables(scan.huff)
    dc_tbls = []
    ac_tbls = []
    for sp in range(scan.n_comps):
        dk = (0, scan.dc_ids[sp])
        ak = (1, scan.ac_ids[sp])
        if dk not in tables:
            raise JpegSyntaxError(f"missing DC Huffman table {scan.dc_ids[sp]}")
        if ak not in tables:
            raise JpegSyntaxError(f"missing AC Huffman table {scan.ac_ids[sp]}")
        dc_tbls.append(tables[dk])
        ac_tbls.append(tables[ak])

    segments = split_restart_segments(scan)
    if scan.interleaved:
        total_mcus = frame.mcus_x * frame.mcus_y
        order = interleaved_block_order(frame, scan)
    else:
        c = frame.components[scan.comp_indices[0]]
        total_mcus = c.width_blocks * c.height_blocks

    # The block sequence of every MCU as (scan position, flat offset of the
    # block in its component's array, component): the decode loop below
    # then touches no frame object.
    dc_luts = [_flat_lut(t) for t in dc_tbls]
    ac_luts = [_flat_lut(t) for t in ac_tbls]
    pos_out: List[List[int]] = [[] for _ in frame.components]
    val_out: List[List[int]] = [[] for _ in frame.components]
    ri = scan.restart_interval or total_mcus
    mcu = 0
    for seg_i, seg in enumerate(segments):
        if mcu >= total_mcus:
            break
        n_mcus = min(ri, total_mcus - mcu)
        blocks = []
        for m in range(mcu, mcu + n_mcus):
            if scan.interleaved:
                my, mx = divmod(m, frame.mcus_x)
                for sp, ci, (v, h) in order:  # type: ignore[misc]
                    blocks.append((sp, mcu_block_index(frame, ci, mx, my, v, h) * 64, ci))
            else:
                ci = scan.comp_indices[0]
                c = frame.components[ci]
                by, bx = divmod(m, c.width_blocks)
                blocks.append((0, (by * c.padded_wb + bx) * 64, ci))
        if _decode_segment(seg, blocks, dc_luts, ac_luts, scan.n_comps, pos_out, val_out):
            raise JpegTruncatedError(f"entropy segment {seg_i} truncated")
        mcu += n_mcus
    if mcu < total_mcus:
        raise JpegTruncatedError(
            f"scan ended after {mcu}/{total_mcus} MCUs (missing restart segments)"
        )
    for ci, (pos, val) in enumerate(zip(pos_out, val_out)):
        if pos:
            coeffs[ci].reshape(-1)[np.asarray(pos, np.int64)] = np.asarray(val, np.int32)


def _flat_lut(tbl: HuffTable) -> List[int]:
    """The table's 16-bit LUT as one list of ``length | symbol << 5``."""
    return ((tbl.lut_sym.astype(np.int64) << 5) | tbl.lut_len).tolist()


def _decode_segment(seg: bytes, blocks, dc_luts, ac_luts, n_comps: int,
                    pos_out: List[List[int]], val_out: List[List[int]]) -> bool:
    """Decode the full blocks of one destuffed restart segment (T.81
    §F.2.2.1-F.2.2.4, fresh DC predictors) into (flat position, value)
    lists per component; the same steps as ``_decode_block_baseline`` with
    the bit reader kept in locals. Returns whether the segment ran past
    its end (fill bits past the pad byte were consumed)."""
    n = len(seg)
    pos = buf = cnt = pad = 0
    pred = [0] * n_comps
    for sp, base, ci in blocks:
        dc_lut, ac_lut = dc_luts[sp], ac_luts[sp]
        po, vo = pos_out[ci], val_out[ci]
        while cnt < 32:
            if pos < n:
                buf = ((buf << 8) | seg[pos]) & 0xFFFFFFFFFFFF
                pos += 1
            else:
                buf = ((buf << 8) | 0xFF) & 0xFFFFFFFFFFFF
                pad += 8
            cnt += 8
        e = dc_lut[(buf >> (cnt - 16)) & 0xFFFF]
        ln = e & 31
        if ln == 0:
            raise JpegHuffmanError("invalid Huffman code")
        cnt -= ln
        t = e >> 5
        if t > 15:
            raise JpegHuffmanError("bad DC size")
        if t:
            v = (buf >> (cnt - t)) & ((1 << t) - 1)
            cnt -= t
            pred[sp] += v if v >= (1 << (t - 1)) else v - (1 << t) + 1
        if pred[sp]:
            po.append(base)
            vo.append(pred[sp])
        k = 1
        while k < 64:
            while cnt < 32:
                if pos < n:
                    buf = ((buf << 8) | seg[pos]) & 0xFFFFFFFFFFFF
                    pos += 1
                else:
                    buf = ((buf << 8) | 0xFF) & 0xFFFFFFFFFFFF
                    pad += 8
                cnt += 8
            e = ac_lut[(buf >> (cnt - 16)) & 0xFFFF]
            ln = e & 31
            if ln == 0:
                raise JpegHuffmanError("invalid Huffman code")
            cnt -= ln
            rs = e >> 5
            size = rs & 0x0F
            if size == 0:
                if rs == 0xF0:
                    k += 16  # ZRL
                    continue
                break  # EOB
            k += rs >> 4
            if k > 63:
                raise JpegHuffmanError("AC run past end of block")
            v = (buf >> (cnt - size)) & ((1 << size) - 1)
            cnt -= size
            po.append(base + k)
            vo.append(v if v >= (1 << (size - 1)) else v - (1 << size) + 1)
            k += 1
    return pad - min(pad, cnt) > 0


# ---------------------------------------------------------------------------
# Progressive decode (T.81 §G.2; structured after libjpeg jdphuff.c)
# ---------------------------------------------------------------------------


def decode_progressive_scan(
    jpeg: JpegData,
    scan: Scan,
    coeffs: List[np.ndarray],
    tables: Optional[Dict[Tuple[int, int], HuffTable]] = None,
) -> None:
    """Apply one progressive scan to the persistent coefficient buffers.

    Four scan kinds (T.81 §G.1.1): DC first (Ss=0, Ah=0), DC refine
    (Ss=0, Ah>0), AC first (Ss>0, Ah=0), AC refine (Ss>0, Ah>0). AC scans
    are always single-component (checked by the parser)."""
    frame = jpeg.frame
    if tables is None:
        tables = build_tables(scan.huff)

    is_dc = scan.ss == 0
    refining = scan.ah != 0

    dc_tbls: List[Optional[HuffTable]] = []
    ac_tbl: Optional[HuffTable] = None
    if is_dc and not refining:
        for sp in range(scan.n_comps):
            dk = (0, scan.dc_ids[sp])
            if dk not in tables:
                raise JpegSyntaxError(f"missing DC Huffman table {scan.dc_ids[sp]}")
            dc_tbls.append(tables[dk])
    if not is_dc:
        ak = (1, scan.ac_ids[0])
        if ak not in tables:
            raise JpegSyntaxError(f"missing AC Huffman table {scan.ac_ids[0]}")
        ac_tbl = tables[ak]

    segments = split_restart_segments(scan)

    if scan.interleaved:
        total_mcus = frame.mcus_x * frame.mcus_y
        order = interleaved_block_order(frame, scan)
    else:
        c0 = frame.components[scan.comp_indices[0]]
        total_mcus = c0.width_blocks * c0.height_blocks

    ri = scan.restart_interval or total_mcus
    al = scan.al
    p1 = 1 << al
    m1 = -1 << al

    mcu = 0
    for seg_i, seg in enumerate(segments):
        if mcu >= total_mcus:
            break
        n_mcus = min(ri, total_mcus - mcu)
        r = BitReader(seg)
        pred = [0] * scan.n_comps
        eobrun = 0
        for m in range(mcu, mcu + n_mcus):
            if is_dc:
                if scan.interleaved:
                    my, mx = divmod(m, frame.mcus_x)
                    blocks = [
                        (sp, coeffs[ci][mcu_block_index(frame, ci, mx, my, v, h)])
                        for sp, ci, (v, h) in order  # type: ignore[misc]
                    ]
                else:
                    ci = scan.comp_indices[0]
                    c = frame.components[ci]
                    by, bx = divmod(m, c.width_blocks)
                    blocks = [(0, coeffs[ci][by * c.padded_wb + bx])]
                for sp, row in blocks:
                    if refining:
                        # §G.1.2.1: one correction bit for the DC coef.
                        if r.receive(1):
                            row[0] |= p1
                    else:
                        t = decode_symbol(r, dc_tbls[sp])  # type: ignore[arg-type]
                        if t > 15:
                            raise JpegHuffmanError("bad DC size")
                        diff = extend(r.receive(t), t)
                        pred[sp] += diff
                        row[0] = pred[sp] << al
            else:
                ci = scan.comp_indices[0]
                c = frame.components[ci]
                by, bx = divmod(m, c.width_blocks)
                row = coeffs[ci][by * c.padded_wb + bx]
                if not refining:
                    eobrun = _ac_first_block(r, ac_tbl, row, scan.ss, scan.se, al, eobrun)
                else:
                    eobrun = _ac_refine_block(
                        r, ac_tbl, row, scan.ss, scan.se, p1, m1, eobrun
                    )
        if r.overrun():
            raise JpegTruncatedError(f"entropy segment {seg_i} truncated")
        mcu += n_mcus
    if mcu < total_mcus:
        raise JpegTruncatedError(
            f"scan ended after {mcu}/{total_mcus} MCUs (missing restart segments)"
        )


def _ac_first_block(
    r: BitReader,
    tbl: HuffTable,
    row: np.ndarray,
    ss: int,
    se: int,
    al: int,
    eobrun: int,
) -> int:
    """AC first pass for one block (T.81 §G.2.2 / jdphuff decode_mcu_AC_first)."""
    if eobrun > 0:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = decode_symbol(r, tbl)
        rr, s = rs >> 4, rs & 0x0F
        if s:
            k += rr
            if k > se:
                raise JpegHuffmanError("AC run past spectral band")
            row[k] = extend(r.receive(s), s) << al
            k += 1
        else:
            if rr != 15:
                eobrun = (1 << rr) - 1
                if rr:
                    eobrun += r.receive(rr)
                return eobrun
            k += 16
    return 0


def _ac_refine_block(
    r: BitReader,
    tbl: HuffTable,
    row: np.ndarray,
    ss: int,
    se: int,
    p1: int,
    m1: int,
    eobrun: int,
) -> int:
    """AC refinement for one block (T.81 §G.1.2.3 / jdphuff
    decode_mcu_AC_refine): corrects already-nonzero coefficients by one
    bit and inserts newly significant ±(1<<Al) coefficients."""
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = decode_symbol(r, tbl)
            rr, s = rs >> 4, rs & 0x0F
            newval = 0
            if s:
                # Newly significant coefficient: sign bit chooses ±p1.
                newval = p1 if r.receive(1) else m1
            else:
                if rr != 15:
                    eobrun = 1 << rr
                    if rr:
                        eobrun += r.receive(rr)
                    break
            # Advance over rr currently-zero coefficients, applying
            # correction bits to nonzero ones encountered on the way.
            while k <= se:
                cv = int(row[k])
                if cv != 0:
                    if r.receive(1):
                        if (cv & p1) == 0:
                            row[k] = cv + (p1 if cv >= 0 else m1)
                else:
                    if rr == 0:
                        break
                    rr -= 1
                k += 1
            if s:
                if k > se:
                    raise JpegHuffmanError("refinement insert past band")
                row[k] = newval
            k += 1
    if eobrun > 0:
        while k <= se:
            cv = int(row[k])
            if cv != 0:
                if r.receive(1):
                    if (cv & p1) == 0:
                        row[k] = cv + (p1 if cv >= 0 else m1)
            k += 1
        eobrun -= 1
    return eobrun


# ---------------------------------------------------------------------------
# Whole-image entropy decode (all scans)
# ---------------------------------------------------------------------------


def alloc_coeffs(frame: Frame) -> List[np.ndarray]:
    """Persistent coefficient storage: per component, MCU-padded block
    grid × 64 coefficients in zigzag order (int32; values fit int16 but
    int32 keeps progressive refinement and dequant simple)."""
    return [
        np.zeros((c.padded_hb * c.padded_wb, 64), dtype=np.int32)
        for c in frame.components
    ]


def decode_all_scans(jpeg: JpegData) -> List[np.ndarray]:
    coeffs = alloc_coeffs(jpeg.frame)
    for scan in jpeg.scans:
        if jpeg.frame.progressive:
            decode_progressive_scan(jpeg, scan, coeffs)
        else:
            decode_baseline_scan(jpeg, scan, coeffs)
    return coeffs
