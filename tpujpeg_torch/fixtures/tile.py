"""Build a giant restart-segmented JPEG from a small one, or a smaller one
from a part of it, on bytes alone, and re-encode a JPEG without restart
markers.

    tile_jpeg(data, nx, ny) -> bytes

    crop_jpeg(data, width, height, x=0, y=0) -> bytes

    norst_jpeg(data, coeffs) -> bytes

The scan is split at its RST markers; each MCU row's segments are
repeated `nx` times across and the rows `ny` times down, the markers
renumbered RST0-RST7 in sequence, and SOF's height and width multiplied.
Every restart segment starts from zero DC predictors, so copied segments
decode to the blocks they held in place: the result's coefficients are
the source's tiled (its pixels too, but where the chroma upsampler reads
across a seam). ``tile_jpeg(420_2048.jpg, 8, 8)`` is the 16384 x 16384
4:2:0 image of the sharded giant-image configuration (about 86 MB).
``crop_jpeg`` keeps the segments of a rectangle of whole segments, so
its coefficients are the source's there; ``crop_jpeg(420_2048.jpg, 512,
512, x, y)`` and its 768x512 and 1024x1024 siblings give the image sizes
of the ImageNet-shard configuration without an encoder.

Needs a baseline (SOF0/SOF1) single-scan file whose restart interval
divides its MCUs per row (so no segment crosses a row) and whose size is
whole MCUs; raises ValueError otherwise. No PIL, no network.

``norst_jpeg`` codes a file's coefficients again as one scan without
restart markers, with the file's own Huffman tables: from the giant
image's coefficients it gives the same image as a marker-free file,
whose entropy decode ``decode_sharded`` shards
(``wavefront.decode_norst_sharded``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_SOF_BASELINE = (0xC0, 0xC1)
_SOF_OTHER = (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)


def _headers(data: bytes) -> Tuple[int, int, int]:
    """(SOF segment offset, restart interval, scan data offset)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("tile_jpeg: missing SOI marker")
    pos, sof, dri = 2, -1, 0
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"tile_jpeg: no marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        length = int.from_bytes(data[pos + 2 : pos + 4], "big")
        if marker in _SOF_BASELINE:
            sof = pos
        elif marker in _SOF_OTHER:
            raise ValueError("tile_jpeg: baseline (SOF0/SOF1) files only")
        elif marker == 0xDD:
            dri = int.from_bytes(data[pos + 4 : pos + 6], "big")
        elif marker == 0xDA:
            if sof < 0:
                raise ValueError("tile_jpeg: SOS before SOF")
            return sof, dri, pos + 2 + length
        pos += 2 + length
    raise ValueError("tile_jpeg: no SOS marker")


def _segments(data: bytes, start: int) -> List[bytes]:
    """The scan's entropy-coded segments, split at RST markers, up to the
    first other marker, which must be EOI (one scan)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    ffs = np.nonzero(arr[start:-1] == 0xFF)[0] + start
    nxt = arr[ffs + 1]
    marks = ffs[(nxt != 0x00) & (nxt != 0xFF)]
    segs, prev = [], start
    for m in marks:
        code = data[m + 1]
        if 0xD0 <= code <= 0xD7:
            segs.append(data[prev:m])
            prev = m + 2
            continue
        if code != 0xD9:
            raise ValueError("tile_jpeg: one scan only (a marker other than RSTn or EOI follows it)")
        segs.append(data[prev:m])
        return segs
    raise ValueError("tile_jpeg: no EOI marker")


def _segment_rows(data: bytes, what: str):
    """(SOF offset, scan data offset, segment width and MCU height in
    pixels, each MCU row's restart segments) of a file whose restart
    interval divides its MCUs per row: the file is len(rows[0]) segments
    wide and len(rows) MCUs high."""
    sof, ri, scan0 = _headers(data)
    height = int.from_bytes(data[sof + 5 : sof + 7], "big")
    width = int.from_bytes(data[sof + 7 : sof + 9], "big")
    ncomp = data[sof + 9]
    hv = [data[sof + 11 + 3 * i] for i in range(ncomp)]
    hmax = max(x >> 4 for x in hv)
    vmax = max(x & 15 for x in hv)
    mcu_w, mcu_h = 8 * hmax, 8 * vmax
    if ncomp == 1:
        mcu_w = mcu_h = 8  # a single-component scan has one block per MCU
    if width % mcu_w or height % mcu_h:
        raise ValueError(f"{what}: {width}x{height} is not whole {mcu_w}x{mcu_h} MCUs")
    mcus_x, mcus_y = width // mcu_w, height // mcu_h
    if ri <= 0 or mcus_x % ri:
        raise ValueError(f"{what}: restart interval {ri} must divide the {mcus_x} MCUs of a row")
    segs = _segments(data, scan0)
    per_row = mcus_x // ri
    if len(segs) != per_row * mcus_y:
        raise ValueError(f"{what}: {len(segs)} segments, expected {per_row * mcus_y}")
    rows = [segs[r * per_row : (r + 1) * per_row] for r in range(mcus_y)]
    return sof, scan0, ri * mcu_w, mcu_h, rows


def _assemble(data: bytes, sof: int, scan0: int, width: int, height: int, order: List[bytes]) -> bytes:
    """`data`'s headers with SOF's size set, then the segments `order` with
    the markers renumbered RST0-RST7 in sequence, then EOI."""
    if width > 0xFFFF or height > 0xFFFF:
        raise ValueError(f"{width}x{height} exceeds SOF's 16-bit size")
    out = bytearray(data[:scan0])
    out[sof + 5 : sof + 7] = height.to_bytes(2, "big")
    out[sof + 7 : sof + 9] = width.to_bytes(2, "big")
    pieces = []
    for k, seg in enumerate(order):
        if k:
            pieces.append(bytes((0xFF, 0xD0 + (k - 1) % 8)))
        pieces.append(seg)
    out += b"".join(pieces)
    out += b"\xff\xd9"
    return bytes(out)


def tile_jpeg(data: bytes, nx: int, ny: int) -> bytes:
    """The JPEG `data` tiled `nx` times across and `ny` times down."""
    if nx < 1 or ny < 1:
        raise ValueError(f"tile_jpeg: nx={nx}, ny={ny}")
    sof, scan0, seg_w, mcu_h, rows = _segment_rows(data, "tile_jpeg")
    order = [seg for _ in range(ny) for row in rows for _ in range(nx) for seg in row]
    return _assemble(data, sof, scan0, seg_w * len(rows[0]) * nx, mcu_h * len(rows) * ny, order)


def crop_jpeg(data: bytes, width: int, height: int, x: int = 0, y: int = 0) -> bytes:
    """The JPEG `data` cut to its `width` x `height` rectangle at pixel
    (x, y), of whole restart segments: x and width multiples of a
    segment's width (restart interval x MCU width), y and height of the
    MCU height."""
    sof, scan0, seg_w, mcu_h, rows = _segment_rows(data, "crop_jpeg")
    if (min(width, height) < 1 or min(x, y) < 0 or x % seg_w or width % seg_w or y % mcu_h or height % mcu_h
            or x + width > seg_w * len(rows[0]) or y + height > mcu_h * len(rows)):
        raise ValueError(f"crop_jpeg: {width}x{height} at ({x}, {y}) is not whole {seg_w}x{mcu_h} "
                         f"segments of the {seg_w * len(rows[0])}x{mcu_h * len(rows)} image")
    order = [seg for row in rows[y // mcu_h : (y + height) // mcu_h] for seg in row[x // seg_w : (x + width) // seg_w]]
    return _assemble(data, sof, scan0, width, height, order)


def _code_table(spec) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol 0..255 of a DHT spec (T.81 Annex C);
    length 0 marks a symbol the table lacks."""
    code_of = np.zeros(256, np.uint64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(int(spec.counts[length - 1])):
            sym = int(spec.values[k])
            code_of[sym], len_of[sym] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _magnitude(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(size category, extra bits) of each value (T.81 F.1.2.1)."""
    cat = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    extra = np.where(v < 0, v + (1 << cat) - 1, v).astype(np.uint64)
    return cat, extra


def _pack(values: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Variable-length codes (values[i] in its low nbits[i] <= 64 bits),
    MSB first and back to back, as bytes; the last byte padded with 1s."""
    pad = -int(nbits.sum()) % 8
    if pad:
        values = np.append(values, np.uint64((1 << pad) - 1))
        nbits = np.append(nbits, pad)
    off = np.cumsum(nbits) - nbits
    word, sh = off >> 6, off & 63
    end = sh + nbits
    one = end <= 64
    first = np.where(one, values << np.where(one, 64 - end, 0).astype(np.uint64),
                     values >> np.where(one, 0, end - 64).astype(np.uint64))
    words = np.zeros(int((off[-1] + nbits[-1] + 63) >> 6) + 1, np.uint64)
    # Codes never share a bit, so a sum over one word is their OR.
    starts = np.flatnonzero(np.diff(word, prepend=-1))
    words[word[starts]] = np.add.reduceat(first, starts)
    spill = np.flatnonzero(~one)
    if len(spill):
        w2 = word[spill] + 1
        rest = values[spill] << (128 - end[spill]).astype(np.uint64)
        s2 = np.flatnonzero(np.diff(w2, prepend=-1))
        words[w2[s2]] |= np.add.reduceat(rest, s2)
    return words.astype(">u8").view(np.uint8)[: int(off[-1] + nbits[-1]) // 8]


def norst_jpeg(data: bytes, coeffs) -> bytes:
    """The baseline single-scan JPEG `data` re-encoded without restart
    markers from its coefficients: coeffs[ci] holds frame component ci's
    zigzag blocks, int [padded_blocks, 64] (the port's entropy decoders'
    form). The file's own Huffman tables code the scan, each DC
    difference now runs across the whole scan, and the DRI segment is
    dropped, so the result decodes to the same coefficients. Raises
    ValueError where a table lacks a symbol the new scan needs, or a run
    of zero runs with its coefficient exceeds 64 bits."""
    from .. import bitstream

    jpeg = bitstream.parse(data)
    frame, scan = jpeg.frame, jpeg.scans[0]
    if frame.progressive or len(jpeg.scans) != 1:
        raise ValueError("norst_jpeg: baseline single-scan files only")
    comps = [frame.components[i] for i in scan.comp_indices]
    blocks, slot_tables = [], []
    for t, c in enumerate(comps):
        grid = np.asarray(coeffs[c.index]).reshape(c.padded_hb, c.padded_wb, 64)
        if scan.interleaved:
            g = grid.reshape(frame.mcus_y, c.v, frame.mcus_x, c.h, 64).transpose(0, 2, 1, 3, 4)
            blocks.append(g.reshape(frame.mcus_y * frame.mcus_x, c.v * c.h, 64))
            slot_tables += [t] * (c.v * c.h)
        else:  # one component: its own block grid in raster order
            blocks.append(grid[: c.height_blocks, : c.width_blocks].reshape(-1, 1, 64))
            slot_tables.append(t)
    z = np.concatenate(blocks, axis=1).astype(np.int32, copy=False)
    per_mcu = z.shape[1]
    z = z.reshape(-1, 64)
    tab = np.tile(np.asarray(slot_tables), len(z) // per_mcu)
    dc_tabs = [_code_table(scan.huff[(0, scan.dc_ids[t])]) for t in range(len(comps))]
    ac_tabs = [_code_table(scan.huff[(1, scan.ac_ids[t])]) for t in range(len(comps))]
    dc_code = np.stack([c for c, _l in dc_tabs]); dc_len = np.stack([l for _c, l in dc_tabs])
    ac_code = np.stack([c for c, _l in ac_tabs]); ac_len = np.stack([l for _c, l in ac_tabs])

    def coded(code_t, len_t, t, sym, what):
        length = len_t[t, sym]
        if (length == 0).any():
            raise ValueError(f"norst_jpeg: the {what} table lacks a symbol the scan needs")
        return code_t[t, sym], length

    # DC: differences along each scan component's blocks, no restarts.
    dc = z[:, 0].astype(np.int64)
    diff = np.empty_like(dc)
    for t in range(len(comps)):
        sel = np.flatnonzero(tab == t)
        diff[sel] = np.diff(dc[sel], prepend=0)
    cat, extra = _magnitude(diff)
    code, length = coded(dc_code, dc_len, tab, cat, "DC")
    dc_val, dc_bits = (code << cat.astype(np.uint64)) | extra, length + cat
    # AC: each nonzero with the ZRLs before it as one code, then EOB.
    b, k = np.nonzero(z[:, 1:])
    k = k + 1
    first = np.r_[True, b[1:] != b[:-1]]
    run = k - np.where(first, 0, np.r_[0, k[:-1]]) - 1
    v = z[b, k].astype(np.int64)
    cat, extra = _magnitude(v)
    code, length = coded(ac_code, ac_len, tab[b], ((run & 15) << 4) | cat, "AC")
    zrl_code, zrl_len = ac_code[tab[b], 0xF0], ac_len[tab[b], 0xF0]
    if ((run >= 16) & (zrl_len == 0)).any():
        raise ValueError("norst_jpeg: the AC table lacks ZRL, which the scan needs")
    ac_val = np.zeros(len(b), np.uint64)
    ac_bits = np.zeros(len(b), np.int64)
    for j in range(3):
        has = (run >> 4) > j
        ac_val = np.where(has, (ac_val << zrl_len.astype(np.uint64)) | zrl_code, ac_val)
        ac_bits = ac_bits + np.where(has, zrl_len, 0)
    ac_val = (((ac_val << length.astype(np.uint64)) | code) << cat.astype(np.uint64)) | extra
    ac_bits = ac_bits + length + cat
    if (ac_bits > 64).any():
        raise ValueError("norst_jpeg: a code with its zero runs exceeds 64 bits")
    nnz = np.bincount(b, minlength=len(z))
    last = np.zeros(len(z), np.int64)
    ends = np.r_[b[1:] != b[:-1], True] if len(b) else np.zeros(0, bool)
    last[b[ends]] = k[ends]
    eob = last < 63
    eob_code, eob_len = coded(ac_code, ac_len, tab[eob], np.zeros(int(eob.sum()), np.int64), "AC")
    # Interleave per block: DC, its AC codes, its EOB.
    count = 1 + nnz + eob
    start = np.cumsum(count) - count
    vals = np.zeros(int(count.sum()), np.uint64)
    bits = np.zeros(len(vals), np.int64)
    vals[start], bits[start] = dc_val, dc_bits
    rank = np.arange(len(b)) - (np.cumsum(nnz) - nnz)[b]
    vals[start[b] + 1 + rank], bits[start[b] + 1 + rank] = ac_val, ac_bits
    e = start[eob] + count[eob] - 1
    vals[e], bits[e] = eob_code, eob_len
    body = _pack(vals, bits)
    body = np.insert(body, np.flatnonzero(body == 0xFF) + 1, 0).tobytes()

    _sof, _ri, scan0 = _headers(data)
    out, pos = bytearray(data[:2]), 2
    while pos < scan0:  # the headers without DRI
        if data[pos + 1] == 0xFF:
            pos += 1
            continue
        end = pos + 2 + int.from_bytes(data[pos + 2 : pos + 4], "big")
        if data[pos + 1] != 0xDD:
            out += data[pos:end]
        pos = end
    return bytes(out) + body + b"\xff\xd9"
