"""ctypes wrapper over the native C++ entropy decoder (SURVEY.md §7.1 M2).

Mirrors tpujpeg.huffman.decode_all_scans exactly: same inputs (parsed
JpegData), same outputs (per-component int32[padded_blocks, 64] zigzag
coefficient arrays), same error taxonomy — validated against the Python
oracle by tests/test_native.py."""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Tuple

import numpy as np

from .. import bitstream
from ..errors import (
    JpegError,
    JpegHuffmanError,
    JpegSyntaxError,
    JpegTruncatedError,
)
from . import build as build_mod

_ERR_MAP = {
    1: JpegHuffmanError,
    2: JpegTruncatedError,
    3: JpegSyntaxError,
}

_HSLOT = 1 + 16 + 256


def _pack_geom(frame: bitstream.Frame) -> np.ndarray:
    g = [frame.n_components, frame.mcus_x, frame.mcus_y]
    for c in frame.components:
        g += [c.h, c.v, c.padded_wb, c.padded_hb, c.width_blocks, c.height_blocks]
    return np.asarray(g, dtype=np.int32)


def _pack_scan(scan: bitstream.Scan) -> np.ndarray:
    s = [scan.n_comps, scan.ss, scan.se, scan.ah, scan.al, scan.restart_interval]
    for p in range(scan.n_comps):
        s += [scan.comp_indices[p], scan.dc_ids[p], scan.ac_ids[p]]
    return np.asarray(s, dtype=np.int32)


def _pack_hspecs(huff: Dict[Tuple[int, int], bitstream.HuffSpec]) -> bytes:
    buf = bytearray(8 * _HSLOT)
    for (tc, th), spec in huff.items():
        if tc > 1 or th > 3:
            continue
        o = (tc * 4 + th) * _HSLOT
        buf[o] = 1
        buf[o + 1 : o + 17] = spec.counts.tobytes()
        vals = spec.values.tobytes()
        buf[o + 17 : o + 17 + len(vals)] = vals
    return bytes(buf)


def _scan_buf(scan: bitstream.Scan) -> Tuple[int, int, np.ndarray]:
    """(pointer, length, keepalive) for scan.data with no copy:
    Scan.data is a memoryview into the original file bytes (parse makes
    no payload copies); np.frombuffer wraps it zero-copy and .ctypes
    exposes the address. Callers must hold the keepalive array across
    the native call."""
    a = np.frombuffer(scan.data, dtype=np.uint8)
    return a.ctypes.data if a.size else 0, a.size, a


def default_threads() -> int:
    env = os.environ.get("TPUJPEG_THREADS")
    if env:
        return max(1, int(env))
    return os.cpu_count() or 1


def decode_scan(
    jpeg: bitstream.JpegData,
    scan: bitstream.Scan,
    coeffs: List[np.ndarray],
    n_threads: int = 0,
) -> None:
    """Decode one scan into the coefficient grids via the native library."""
    lib = build_mod.get_lib()
    frame = jpeg.frame
    if n_threads <= 0:
        n_threads = default_threads()

    geom = _pack_geom(frame)
    sp = _pack_scan(scan)
    hspec = _pack_hspecs(scan.huff)
    rsts = np.asarray(scan.rst_offsets, dtype=np.int64)
    err = ctypes.create_string_buffer(256)

    ptrs = []
    for ci in range(4):
        if ci < len(coeffs):
            arr = coeffs[ci]
            assert arr.dtype == np.int32 and arr.flags.c_contiguous
            ptrs.append(arr.ctypes.data_as(ctypes.c_void_p))
        else:
            ptrs.append(None)

    dptr, dlen, _keep = _scan_buf(scan)
    code = lib.tj_decode_scan(
        dptr,
        dlen,
        rsts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(scan.rst_offsets),
        geom.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hspec,
        *ptrs,
        int(frame.progressive),
        n_threads,
        err,
        256,
    )
    if code != 0:
        exc = _ERR_MAP.get(code, JpegError)
        raise exc(err.value.decode("utf-8", "replace"))


def decode_all_scans(
    jpeg: bitstream.JpegData, n_threads: int = 0
) -> List[np.ndarray]:
    frame = jpeg.frame
    coeffs = [
        np.zeros((c.padded_hb * c.padded_wb, 64), dtype=np.int32)
        for c in frame.components
    ]
    for scan in jpeg.scans:
        decode_scan(jpeg, scan, coeffs, n_threads=n_threads)
    return coeffs


def destuff_segments(scan: bitstream.Scan) -> Tuple[np.ndarray, np.ndarray]:
    """Destuff a scan in one native pass. Returns (bytes_u8, seg_starts)
    where seg_starts[i] is segment i's start offset in the destuffed
    buffer and seg_starts[-1] its total length — the segment index table
    shipped to the device wavefront decoder (SURVEY.md §3.4).

    The result is cached on the Scan (destuffed / dseg_starts): the
    no-restart skeleton flow destuffs repeatedly (build_norst_plan
    retries its split width), and the wavefront row fill reuses the
    cache via rows_from_dest. Callers treat the buffer as read-only."""
    if scan.destuffed is not None and scan.dseg_starts is not None:
        return scan.destuffed, scan.dseg_starts
    lib = build_mod.get_lib()
    n_rst = len(scan.rst_offsets)
    dptr, dlen, _keep = _scan_buf(scan)
    out = np.empty(dlen, dtype=np.uint8)
    starts = np.zeros(n_rst + 2, dtype=np.int64)
    rsts = np.asarray(scan.rst_offsets, dtype=np.int64)
    total = lib.tj_destuff_segments(
        dptr,
        dlen,
        rsts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_rst,
        out.ctypes.data_as(ctypes.c_void_p),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    scan.destuffed = out[:total]
    scan.dseg_starts = starts
    return scan.destuffed, scan.dseg_starts


def _blocks_sp(jpeg: bitstream.JpegData, scan: bitstream.Scan):
    frame = jpeg.frame
    if scan.interleaved:
        total = frame.mcus_x * frame.mcus_y
        blocks_sp: list = []
        for p, ci in enumerate(scan.comp_indices):
            c = frame.components[ci]
            blocks_sp += [p] * (c.h * c.v)
    else:
        c0 = frame.components[scan.comp_indices[0]]
        total = c0.width_blocks * c0.height_blocks
        blocks_sp = [0]
    return total, blocks_sp


def scan_split_buf(
    destuffed: np.ndarray,
    jpeg: bitstream.JpegData,
    scan: bitstream.Scan,
    total_mcus: int,
    every: int,
    n_threads: int = 0,
) -> np.ndarray:
    """Skeleton-scan `total_mcus` MCUs of a DESTUFFED buffer (symbol
    lengths only, no coefficient stores), recording the bit offset AND
    the DC predictor values at every `every`-th MCU. Returns
    (offs_i64, dcs_i32): offs has ceil(total/every)+1 entries, the last
    being total bits consumed; dcs is [n_entries, n_scan_comps] — the
    per-lane predictor priming that lets the fused pixels kernel decode
    skeleton lanes with true DCs (no device prefix fixup).

    Large buffers take the SPECULATIVE parallel walk (tj_scan_split_spec:
    workers decode from byte-aligned guesses, Huffman self-sync makes the
    guesses converge, a serial stitch validates — SURVEY.md §5
    long-context item 4); output is bit-identical to the serial walk.
    Small buffers stay serial (the resync prefix would dominate)."""
    lib = build_mod.get_lib()
    _tot, blocks_sp = _blocks_sp(jpeg, scan)
    bsp = np.asarray(blocks_sp, dtype=np.int32)
    n_off = -(-total_mcus // every) + 1
    offs = np.zeros(n_off, dtype=np.int64)
    dcs = np.zeros((n_off, scan.n_comps), dtype=np.int32)
    err = ctypes.create_string_buffer(256)
    destuffed = np.ascontiguousarray(destuffed)
    if n_threads <= 0:
        n_threads = min(default_threads(), max(1, len(destuffed) >> 19))
    if n_threads > 1:
        code = lib.tj_scan_split_spec(
            destuffed.ctypes.data_as(ctypes.c_void_p),
            len(destuffed),
            _pack_scan(scan).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _pack_hspecs(scan.huff),
            bsp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(blocks_sp),
            total_mcus,
            every,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_threads,
            err,
            256,
        )
    else:
        code = lib.tj_scan_split(
            destuffed.ctypes.data_as(ctypes.c_void_p),
            len(destuffed),
            _pack_scan(scan).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _pack_hspecs(scan.huff),
            bsp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(blocks_sp),
            total_mcus,
            every,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            err,
            256,
        )
    if code != 0:
        exc = _ERR_MAP.get(code, JpegError)
        raise exc(err.value.decode("utf-8", "replace"))
    return offs, dcs


def scan_split(
    jpeg: bitstream.JpegData,
    scan: bitstream.Scan,
    every: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Skeleton-scan a no-restart baseline scan: one fast native walk
    that records the bit offset of every `every`-th MCU in the DESTUFFED
    stream — the serial prefix that turns a marker-free stream into
    wavefront lanes (SURVEY.md §5 long-context item 3). Returns
    (destuffed_u8, bit_offs_i64) — use scan_split_buf directly for the
    per-lane DC predictors."""
    total, _sp = _blocks_sp(jpeg, scan)
    destuffed, _ = destuff_segments(scan)
    return destuffed, scan_split_buf(destuffed, jpeg, scan, total, every)[0]


def find_scan_end(data: bytes, start: int) -> Tuple[int, np.ndarray]:
    """Native twin of bitstream._find_scan_end (memchr-driven walk);
    same (end_pos, rst_offsets) contract, validated against both the
    vectorized and byte-serial Python references in tests. This is the
    parse stage's hot loop on multi-megabyte scans."""
    lib = build_mod.get_lib()
    n = len(data)
    # RST markers are >= 2 bytes apart so (n-start)/2 bounds the count;
    # start smaller (segments are usually >> 32 B) and re-call with the
    # true count if the guess was short.
    cap = max(16, (n - start) // 32)
    while True:
        out = np.empty(cap, dtype=np.int64)
        n_rst = ctypes.c_int64(0)
        end = lib.tj_find_scan_end(
            data, n, start,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cap, ctypes.byref(n_rst),
        )
        if n_rst.value <= cap:
            return int(end), out[: n_rst.value]
        cap = int(n_rst.value)


def scan_walk(
    data: bytes, start: int
) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Fused find_scan_end + destuff_segments: ONE native pass over the
    scan payload returns (end_pos, rst_offsets_i64, destuffed_u8,
    seg_starts_i64). rst_offsets are stuffed-byte offsets relative to
    `start` (identical to find_scan_end); seg_starts[i] is segment i's
    start in the destuffed buffer with seg_starts[-1] its total length
    (identical to destuff_segments). Measured NOT worth wiring into
    parse() by default: the intermediate destuffed buffer's extra
    write+read loses to the second memchr pass it saves on this host
    (bitstream._scan_end docstring has the numbers) — available for
    flows that want end + segments + destuffed bytes in one read."""
    lib = build_mod.get_lib()
    n = len(data)
    out = np.empty(max(n - start, 1), dtype=np.uint8)
    cap = max(16, (n - start) // 32)
    while True:
        rst = np.empty(cap, dtype=np.int64)
        starts = np.zeros(cap + 2, dtype=np.int64)
        n_rst = ctypes.c_int64(0)
        end = lib.tj_scan_walk(
            data, n, start,
            rst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cap, ctypes.byref(n_rst),
            out.ctypes.data_as(ctypes.c_void_p),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if n_rst.value <= cap:
            k = n_rst.value
            return (
                int(end),
                rst[:k],
                out[: starts[k + 1]],
                starts[: k + 2],
            )
        cap = int(n_rst.value)


def rows_from_dest(
    destuffed: np.ndarray,
    seg_starts: np.ndarray,
    lane0: int,
    n_seg: int,
    row_words: int,
    out_words: np.ndarray,
    out_bits: np.ndarray,
    n_threads: int = 0,
) -> None:
    """destuff_rows from an already-destuffed buffer (scan_walk output):
    memcpy + pad + byte-swap only, no memchr re-walk. `lane0` offsets
    into seg_starts (decode_sharded slices a shard's lane range)."""
    lib = build_mod.get_lib()
    if n_threads <= 0:
        # Size the pool on the bytes this call actually fills (a sharded
        # caller slices a small [lane0, lane0+n_seg] range out of a large
        # destuffed buffer); small fills are faster serial.
        fill_bytes = int(seg_starts[lane0 + n_seg] - seg_starts[lane0])
        n_threads = min(default_threads(), max(1, fill_bytes >> 23))
    assert out_words.dtype == np.int32 and out_words.flags.c_contiguous
    assert seg_starts.dtype == np.int64
    starts = seg_starts[lane0 : lane0 + n_seg + 1]
    starts = np.ascontiguousarray(starts)
    rc = lib.tj_rows_from_dest(
        destuffed.ctypes.data_as(ctypes.c_void_p),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_seg,
        row_words,
        out_words.ctypes.data_as(ctypes.c_void_p),
        out_bits.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if rc != 0:
        raise JpegTruncatedError("segment exceeds wavefront row capacity")


def destuff_rows(
    scan: bitstream.Scan,
    n_seg: int,
    row_words: int,
    out_words: np.ndarray,
    out_bits: np.ndarray,
    n_threads: int = 0,
) -> None:
    """Destuff every restart segment straight into fixed-width,
    byte-swapped int32 word rows (the Pallas wavefront kernel's input
    layout). out_words: int32[n_seg(+pad), row_words] C-contiguous slice;
    out_bits: int32[n_seg]."""
    lib = build_mod.get_lib()
    if n_threads <= 0:
        # Thread spawn costs ~0.1-0.2 ms; a whole ~1 MB scan destuffs in
        # under 1 ms single-thread, so small scans are FASTER serial
        # (measured: nt=4 is 27% slower than nt=1 on a 1.3 MB scan).
        # Spin up one worker per ~4 MB of scan, capped at the CPU count
        # — giant scans (decode_sharded, 16K images) still fan out.
        n_threads = min(
            default_threads(), max(1, len(scan.data) >> 22)
        )
    rsts = np.asarray(scan.rst_offsets, dtype=np.int64)
    assert out_words.dtype == np.int32 and out_words.flags.c_contiguous
    dptr, dlen, _keep = _scan_buf(scan)
    rc = lib.tj_destuff_rows(
        dptr,
        dlen,
        rsts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(scan.rst_offsets),
        n_seg,
        row_words,
        out_words.ctypes.data_as(ctypes.c_void_p),
        out_bits.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if rc != 0:
        raise JpegTruncatedError("segment exceeds wavefront row capacity")
