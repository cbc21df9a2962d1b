"""JPEG marker-level bitstream parser (SURVEY.md §2.1 components 1-6, 9).

Host-side, metadata-sized work: walks SOI→EOI, collects quantization and
Huffman table definitions, frame and scan headers, the restart interval,
and slices out the entropy-coded data of every scan (with the byte offsets
of RSTn markers inside each scan, which are the parallel-decode split
points — SURVEY.md §2.3 "restart-segment sharding").

Conforms to ITU-T Rec. T.81 §B.2 (marker syntax). The reference decoder's
equivalent is its C++ marker parser (SURVEY.md §2.1 #2; reference checkout
is an empty mount, see SURVEY.md §0, so citations are to the standard and
the survey rather than reference file:line).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import spans
from .errors import (
    JpegSyntaxError,
    JpegTruncatedError,
    JpegUnsupportedError,
)

# Marker bytes (second byte of the 0xFF xx pair), T.81 Table B.1.
M_SOF0 = 0xC0  # baseline sequential DCT
M_SOF1 = 0xC1  # extended sequential DCT, Huffman
M_SOF2 = 0xC2  # progressive DCT, Huffman
M_SOF3 = 0xC3  # lossless
M_DHT = 0xC4
M_SOF5 = 0xC5
M_SOF6 = 0xC6
M_SOF7 = 0xC7
M_JPG = 0xC8
M_SOF9 = 0xC9
M_SOF10 = 0xCA
M_SOF11 = 0xCB
M_DAC = 0xCC
M_SOF13 = 0xCD
M_SOF14 = 0xCE
M_SOF15 = 0xCF
M_RST0 = 0xD0
M_RST7 = 0xD7
M_SOI = 0xD8
M_EOI = 0xD9
M_SOS = 0xDA
M_DQT = 0xDB
M_DNL = 0xDC
M_DRI = 0xDD
M_APP0 = 0xE0
M_APP15 = 0xEF
M_COM = 0xFE

# JPEG zigzag order: ZIGZAG[k] = natural (row-major) index of the k-th
# coefficient in zigzag scan order (T.81 Figure A.6).
ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)
# Inverse: NATURAL_TO_ZIGZAG[n] = zigzag position of natural index n.
NATURAL_TO_ZIGZAG = np.argsort(ZIGZAG).astype(np.int32)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class HuffSpec:
    """Raw DHT payload: BITS[1..16] code-length counts + HUFFVAL symbols
    (T.81 §B.2.4.2). Table *construction* lives in huffman.py."""

    tc: int  # 0 = DC, 1 = AC
    th: int  # table id 0..3
    counts: np.ndarray  # uint8[16]
    values: np.ndarray  # uint8[n]

    def key(self) -> Tuple[int, int]:
        return (self.tc, self.th)


@dataclasses.dataclass
class Component:
    """Per-component frame parameters (T.81 §B.2.2)."""

    index: int  # position in SOF component list
    cid: int  # component identifier Ci
    h: int  # horizontal sampling factor Hi
    v: int  # vertical sampling factor Vi
    tq: int  # quantization table selector Tqi

    # Derived geometry, filled by Frame.finalize():
    dwidth: int = 0  # downsampled sample width  = ceil(W * h / hmax)
    dheight: int = 0  # downsampled sample height = ceil(H * v / vmax)
    width_blocks: int = 0  # ceil(dwidth / 8)  — true block count
    height_blocks: int = 0  # ceil(dheight / 8)
    padded_wb: int = 0  # mcus_x * h — MCU-padded block columns
    padded_hb: int = 0  # mcus_y * v — MCU-padded block rows


@dataclasses.dataclass
class Frame:
    """SOF frame header + derived MCU geometry (T.81 §B.2.2, §A.2.3)."""

    progressive: bool
    precision: int
    height: int
    width: int
    components: List[Component]

    hmax: int = 1
    vmax: int = 1
    mcus_x: int = 0
    mcus_y: int = 0

    def finalize(self) -> None:
        self.hmax = max(c.h for c in self.components)
        self.vmax = max(c.v for c in self.components)
        self.mcus_x = _ceil_div(self.width, 8 * self.hmax)
        self.mcus_y = _ceil_div(self.height, 8 * self.vmax)
        for c in self.components:
            c.dwidth = _ceil_div(self.width * c.h, self.hmax)
            c.dheight = _ceil_div(self.height * c.v, self.vmax)
            c.width_blocks = _ceil_div(c.dwidth, 8)
            c.height_blocks = _ceil_div(c.dheight, 8)
            c.padded_wb = self.mcus_x * c.h
            c.padded_hb = self.mcus_y * c.v

    @property
    def n_components(self) -> int:
        return len(self.components)

    def blocks_per_mcu(self) -> int:
        return sum(c.h * c.v for c in self.components)


@dataclasses.dataclass
class Scan:
    """One SOS header + its entropy-coded payload (T.81 §B.2.3).

    `data` is the raw (still byte-stuffed) entropy segment with RSTn
    markers embedded; `rst_offsets` are byte offsets *into data* of each
    0xFFDn pair, which split the stream into independently decodable
    restart segments (T.81 §E.2.4: DC predictors and EOB runs reset, so
    segments share no state — the parallelism substrate, SURVEY.md §3.4).
    """

    comp_indices: List[int]  # indices into frame.components
    dc_ids: List[int]  # Td per scan component
    ac_ids: List[int]  # Ta per scan component
    ss: int
    se: int
    ah: int
    al: int
    restart_interval: int  # DRI value in force for this scan
    data: bytes  # bytes-like; parse() stores a zero-copy memoryview
    rst_offsets: List[int]
    # Table state snapshots at scan start (tables may be redefined
    # between scans in progressive files):
    huff: Dict[Tuple[int, int], HuffSpec] = dataclasses.field(default_factory=dict)
    # Destuffed-payload cache, filled by native.entropy.destuff_segments
    # on first use (the skeleton/no-restart flows destuff repeatedly —
    # build_norst_plan retries its split width up to 6x): `destuffed`
    # holds every segment's entropy bytes back to back and
    # `dseg_starts[i]` is segment i's start offset (last entry = total
    # length). None until a destuff-consuming flow runs; the fused-plan
    # row fill then uses the cache (rows_from_dest) instead of a second
    # memchr walk.
    destuffed: Optional[np.ndarray] = None
    dseg_starts: Optional[np.ndarray] = None

    @property
    def n_comps(self) -> int:
        return len(self.comp_indices)

    @property
    def interleaved(self) -> bool:
        return self.n_comps > 1


@dataclasses.dataclass
class JpegData:
    """Everything the entropy + transform stages need for one image."""

    frame: Frame
    scans: List[Scan]
    qtables: Dict[int, np.ndarray]  # id -> int32[64] in zigzag order
    restart_interval: int  # last DRI seen (informational)
    adobe_transform: Optional[int] = None  # APP14 color transform flag
    saw_jfif: bool = False  # APP0 "JFIF" marker present


def color_space(jpeg: "JpegData") -> str:
    """Decoded color interpretation of the component planes, following
    libjpeg's jdmaster.c default_decompress_parms selection (JFIF marker
    beats Adobe APP14 beats component-id heuristics) so output matches
    PIL/libjpeg byte-for-byte on every marker combination.

    Returns one of 'gray', 'ycbcr', 'rgb', 'cmyk', 'ycck'. For 'cmyk'/
    'ycck' the decoder emits Adobe-polarity CMYK exactly as PIL does
    (JpegImagePlugin rawmode 'CMYK;I' — all four channels inverted)."""
    n = jpeg.frame.n_components
    if n == 1:
        return "gray"
    if n == 3:
        if jpeg.saw_jfif:
            return "ycbcr"
        if jpeg.adobe_transform is not None:
            return "rgb" if jpeg.adobe_transform == 0 else "ycbcr"
        cids = [c.cid for c in jpeg.frame.components]
        if cids == [0x52, 0x47, 0x42]:  # 'R','G','B'
            return "rgb"
        return "ycbcr"
    # 4 components.
    if jpeg.adobe_transform is not None:
        return "cmyk" if jpeg.adobe_transform == 0 else "ycck"
    return "cmyk"


class _ByteCursor:
    __slots__ = ("data", "pos", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.n = len(data)

    def u8(self) -> int:
        if self.pos >= self.n:
            raise JpegTruncatedError("unexpected end of file")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def u16(self) -> int:
        if self.pos + 2 > self.n:
            raise JpegTruncatedError("unexpected end of file")
        v = (self.data[self.pos] << 8) | self.data[self.pos + 1]
        self.pos += 2
        return v

    def take(self, k: int) -> bytes:
        if self.pos + k > self.n:
            raise JpegTruncatedError("unexpected end of file")
        b = self.data[self.pos : self.pos + k]
        self.pos += k
        return b


def _find_scan_end(data: bytes, start: int) -> Tuple[int, List[int]]:
    """Scan entropy-coded data from `start`; return (end_pos, rst_offsets).

    Entropy data ends at the first 0xFF followed by a byte that is neither
    0x00 (stuffed data byte, T.81 §B.1.1.5) nor RST0..RST7 (T.81 §E.2.4)
    nor another 0xFF (fill byte, §B.1.1.2). rst_offsets are relative to
    `start`.

    Vectorized: classify every 0xFF position at once. Equivalent to the
    byte-serial walk because the byte after a stuffed pair or marker can
    never itself be part of another 0xFF pair's *second* byte in a way
    that changes classification (it is only ever skipped when it cannot
    be 0xFF).
    """
    arr = np.frombuffer(data, dtype=np.uint8)[start:]
    ffs = np.nonzero(arr[:-1] == 0xFF)[0] if len(arr) > 1 else np.empty(0, np.int64)
    if len(ffs) == 0:
        return len(data), np.empty(0, np.int64)
    nxt = arr[ffs + 1]
    is_term = (
        (nxt != 0x00)
        & (nxt != 0xFF)
        & ~((nxt >= M_RST0) & (nxt <= M_RST7))
    )
    term_idx = np.nonzero(is_term)[0]
    if len(term_idx) == 0:
        end_rel = len(arr)  # truncated: decoder raises if it needed more
    else:
        end_rel = int(ffs[term_idx[0]])
    is_rst = (nxt >= M_RST0) & (nxt <= M_RST7) & (ffs < end_rel)
    rsts = ffs[is_rst].astype(np.int64)  # kept as ndarray: hot consumers
    return start + end_rel if len(term_idx) else len(data), rsts


_NATIVE_SCAN_END = 0  # 0 = untried, 1 = available, -1 = unavailable


def _scan_end(data: bytes, start: int) -> Tuple[int, List[int]]:
    """_find_scan_end via the native memchr walk when the C++ library is
    buildable (parse's hot loop: ~10x the numpy classifier), falling back
    to the vectorized Python version otherwise. Both are pinned to the
    byte-serial reference by tests/test_bitstream.py.

    Measured and rejected here: the FUSED walk (tj_scan_walk — end +
    RSTn + destuff in one read) makes parse carry a destuffed copy of
    every scan, and that intermediate buffer's extra write+read costs
    more than the second memchr pass it saves (86 MB corpus, q85-q98:
    two-pass 31-75 ms vs fused 40-86 ms). The fused primitive remains
    for destuff-consuming flows via native.entropy.scan_walk;
    destuff_segments() caches its result on the Scan so those flows
    destuff once."""
    global _NATIVE_SCAN_END
    if _NATIVE_SCAN_END >= 0:
        try:
            from .native import entropy as _native

            end, rsts = _native.find_scan_end(data, start)
            _NATIVE_SCAN_END = 1
            return end, rsts
        except Exception:  # no g++ / build failure: never fatal here
            _NATIVE_SCAN_END = -1
    return _find_scan_end(data, start)


@spans.spanned(spans.PARSE)
def parse(data: bytes) -> JpegData:
    """Parse a complete JFIF/JPEG byte string into structured metadata +
    raw scan payloads. Raises JpegSyntaxError / JpegUnsupportedError."""
    cur = _ByteCursor(data)
    if cur.u16() != 0xFFD8:
        raise JpegSyntaxError("missing SOI marker")

    qtables: Dict[int, np.ndarray] = {}
    htables: Dict[Tuple[int, int], HuffSpec] = {}
    restart_interval = 0
    frame: Optional[Frame] = None
    scans: List[Scan] = []
    adobe_transform: Optional[int] = None
    saw_jfif = False

    while True:
        # Advance to next marker: skip fill bytes (any number of 0xFF).
        b = cur.u8()
        if b != 0xFF:
            raise JpegSyntaxError(f"expected marker, got byte {b:#x} at {cur.pos - 1}")
        marker = cur.u8()
        while marker == 0xFF:
            marker = cur.u8()

        if marker == M_EOI:
            break

        if marker == M_SOI or (M_RST0 <= marker <= M_RST7) or marker == 0x01:
            raise JpegSyntaxError(f"unexpected standalone marker {marker:#x}")

        length = cur.u16()
        if length < 2:
            raise JpegSyntaxError(f"bad segment length {length} for marker {marker:#x}")
        seg_end = cur.pos + length - 2

        if marker == M_DQT:
            # T.81 §B.2.4.1: one or more (Pq,Tq)+table entries.
            while cur.pos < seg_end:
                pqtq = cur.u8()
                pq, tq = pqtq >> 4, pqtq & 0x0F
                if pq not in (0, 1) or tq > 3:
                    raise JpegSyntaxError("bad DQT precision/id")
                if pq == 0:
                    raw = np.frombuffer(cur.take(64), dtype=np.uint8)
                else:
                    raw = np.frombuffer(cur.take(128), dtype=">u2")
                qtables[tq] = raw.astype(np.int32)  # zigzag order
        elif marker == M_DHT:
            # T.81 §B.2.4.2.
            while cur.pos < seg_end:
                tcth = cur.u8()
                tc, th = tcth >> 4, tcth & 0x0F
                if tc > 1 or th > 3:
                    raise JpegSyntaxError("bad DHT class/id")
                counts = np.frombuffer(cur.take(16), dtype=np.uint8).copy()
                total = int(counts.sum())
                if total > 256:
                    raise JpegSyntaxError("DHT has >256 symbols")
                # Canonical-code overflow check, exactly libjpeg's
                # jdhuff.c bound (code, one past the last assigned at
                # length l, must fit in l bits — the all-ones code is
                # rejected too): a corrupt table dies HERE with a
                # defined error instead of reaching a decoder — or
                # baking garbage constants into a fresh kernel compile.
                code = 0
                for l in range(1, 17):
                    code += int(counts[l - 1])
                    if code >= (1 << l):
                        raise JpegSyntaxError(
                            "bogus Huffman table: code overflow at "
                            f"length {l}"
                        )
                    code <<= 1
                values = np.frombuffer(cur.take(total), dtype=np.uint8).copy()
                htables[(tc, th)] = HuffSpec(tc, th, counts, values)
        elif marker == M_DRI:
            restart_interval = cur.u16()  # T.81 §B.2.4.4
        elif marker in (M_SOF0, M_SOF1, M_SOF2):
            if frame is not None:
                raise JpegSyntaxError("multiple SOF markers")
            precision = cur.u8()
            if precision != 8:
                raise JpegUnsupportedError(f"{precision}-bit precision unsupported")
            height = cur.u16()
            width = cur.u16()
            ncomp = cur.u8()
            if ncomp not in (1, 3, 4):
                raise JpegUnsupportedError(f"{ncomp} components unsupported")
            comps: List[Component] = []
            for i in range(ncomp):
                cid = cur.u8()
                hv = cur.u8()
                tq = cur.u8()
                h, v = hv >> 4, hv & 0x0F
                if not (1 <= h <= 4 and 1 <= v <= 4):
                    raise JpegSyntaxError("bad sampling factors")
                comps.append(Component(index=i, cid=cid, h=h, v=v, tq=tq))
            if height == 0:
                raise JpegUnsupportedError("DNL-deferred height unsupported")
            frame = Frame(
                progressive=(marker == M_SOF2),
                precision=precision,
                height=height,
                width=width,
                components=comps,
            )
            frame.finalize()
        elif marker in (
            M_SOF3, M_SOF5, M_SOF6, M_SOF7, M_SOF9, M_SOF10, M_SOF11,
            M_SOF13, M_SOF14, M_SOF15, M_DAC,
        ):
            raise JpegUnsupportedError(
                f"SOF/DAC marker {marker:#x} (lossless/arithmetic/hierarchical) unsupported"
            )
        elif marker == M_SOS:
            if frame is None:
                raise JpegSyntaxError("SOS before SOF")
            ns = cur.u8()
            if not (1 <= ns <= 4):
                raise JpegSyntaxError("bad scan component count")
            comp_indices: List[int] = []
            dc_ids: List[int] = []
            ac_ids: List[int] = []
            by_cid = {c.cid: c for c in frame.components}
            for _ in range(ns):
                cs = cur.u8()
                tdta = cur.u8()
                if cs not in by_cid:
                    raise JpegSyntaxError(f"scan references unknown component {cs}")
                comp_indices.append(by_cid[cs].index)
                dc_ids.append(tdta >> 4)
                ac_ids.append(tdta & 0x0F)
            ss = cur.u8()
            se = cur.u8()
            ahal = cur.u8()
            ah, al = ahal >> 4, ahal & 0x0F
            if not frame.progressive:
                # Baseline scans must cover the full band (T.81 §B.2.3).
                if ss != 0 or se != 63 or ah != 0 or al != 0:
                    raise JpegSyntaxError("bad Ss/Se/Ah/Al for sequential scan")
            else:
                if ss > 63 or se > 63 or se < ss:
                    raise JpegSyntaxError("bad spectral band")
                if ss == 0 and se != 0:
                    raise JpegSyntaxError("progressive DC scan must have Se=0")
                if ss > 0 and ns != 1:
                    raise JpegSyntaxError("progressive AC scan must be single-component")
            end, rsts = _scan_end(data, cur.pos)
            scan = Scan(
                comp_indices=comp_indices,
                dc_ids=dc_ids,
                ac_ids=ac_ids,
                ss=ss,
                se=se,
                ah=ah,
                al=al,
                restart_interval=restart_interval,
                # Zero-copy view: the scan payload is the bulk of the
                # file and copying it dominated parse time (~37 ms /
                # 86 MB on this host). Native consumers take a pointer
                # into the original buffer (_scan_buf); python fallbacks
                # materialize bytes only where a bytes method needs it.
                data=memoryview(data)[cur.pos : end],
                rst_offsets=rsts,
                huff=dict(htables),
            )
            scans.append(scan)
            cur.pos = end
            continue  # scan payload consumed; no seg_end skip
        elif marker == M_DNL:
            raise JpegUnsupportedError("DNL unsupported")
        elif M_APP0 <= marker <= M_APP15 or marker == M_COM:
            if marker == M_APP0 and length >= 7:
                if data[cur.pos : cur.pos + 5] == b"JFIF\x00":
                    saw_jfif = True
            if marker == M_APP0 + 14 and length >= 14:
                payload = data[cur.pos : seg_end]
                if payload[:5] == b"Adobe":
                    adobe_transform = payload[11]
        else:
            pass  # unknown-but-length-prefixed: skip

        cur.pos = seg_end

    if frame is None:
        raise JpegSyntaxError("no SOF marker")
    if not scans:
        raise JpegSyntaxError("no SOS marker")
    for c in frame.components:
        if c.tq not in qtables:
            raise JpegSyntaxError(f"component {c.cid} references missing DQT {c.tq}")
    return JpegData(
        frame=frame,
        scans=scans,
        qtables=qtables,
        restart_interval=restart_interval,
        adobe_transform=adobe_transform,
        saw_jfif=saw_jfif,
    )


def split_restart_segments(scan: Scan) -> List[bytes]:
    """Split a scan payload into destuffed restart segments.

    Returns the list of entropy segments with 0xFF00 stuffing removed
    (T.81 §B.1.1.5) and RSTn markers stripped; each segment is
    independently decodable with fresh DC predictors (T.81 §E.2.4).
    """
    pieces: List[bytes] = []
    start = 0
    for off in scan.rst_offsets:
        pieces.append(scan.data[start:off])
        start = off + 2
    pieces.append(scan.data[start:])
    # bytes() materializes memoryview pieces (Scan.data is a zero-copy
    # view); this is the python fallback path, the native destuff never
    # comes through here.
    return [bytes(p).replace(b"\xff\x00", b"\xff") for p in pieces]
