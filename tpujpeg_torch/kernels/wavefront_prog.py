"""Progressive scans on the device: the four T.81 §G scan kinds applied to
a batch's coefficient state, restart segments as lanes.

Port of ``tpujpeg/kernels/wavefront_prog.py``: the scan planner
(``_seg_geometry``, ``_stuffed_width``, the native row fill of
``_fill_rows``, ``ScanPlan``, ``_tables_for_scan``), the scan kinds

  DC first   kernel 7, ``tj_prog_dc_first`` (``_make_dc_first_kernel``)
  DC refine  no kernel: a host bit unpack (``_dc_refine_masks``) and a
             device OR, as in the reference
  AC first   kernel 8, ``tj_prog_ac_first`` (``_make_ac_first_kernel``)
  AC refine  kernel 9, ``tj_prog_ac_refine`` (``_make_ac_refine_kernel``)

(CUDA kernels in ``csrc/prog.cu``), and the driver and entries
``apply_scan_batch``, ``decode_all_scans_batch``,
``decode_all_scans_to_rgb_batch``, ``resolve_scan_errors``,
``decode_all_scans``, ``scan_group_key`` and ``prog_launch_key``.

The batch state is, per frame component, int32 [N, padded_blocks, 64]
zigzag AC coefficients (column 0 left 0) and int32 [N, padded_blocks] DC
columns, the arrays ``pipeline.transform_batch`` takes. Each kernel places
a lane's blocks at their raster index from the lane's first MCU, so the
reference's lane<->grid conversions (``_flat_lanes``, ``_scatter_dc_s``,
``_grids_to_lanes_s``, ``.at[].add/.set``) have no counterpart: kernel 7
stores pred << Al into the DC columns, kernel 8 adds val << Al into the
band (the reference adds its block into the state), kernel 9 rewrites the
band of each block in place. Lanes are a flat [L] axis (no [G, 8, K]
groups) and tables are runtime data (the reference's baked/table-dynamic
split collapses into one form, so its ``dyn`` has no counterpart); each
plan carries its tables' 9-bit lookahead (``ScanPlan.luts``), built once
per distinct table on the host, which the kernels copy into shared
memory. The planner keeps the reference's limits (the W rule,
``MAX_WORDS``, the one-segment scan over 2040 bytes) so that both
decoders accept and reject the same streams.

A group is keyed by ``prog_launch_key``: one frame geometry and scan
script, whatever Huffman tables each image carries (the reference keys by
``scan_group_key``, tables included, and takes every scan's tables from
the group's first image). A scan's plan holds the group's distinct table
sets for that scan (``ScanPlan.tables``, ``huffval``, ``luts``, one entry
per set) and each image's set (``ScanPlan.image_set``); with more than one
set each image's lanes start on a CTA boundary, so that a CTA stages the
one set of its first lane's image. A group whose members' keys differ
raises JpegUnsupportedError.

Each kernel's plain version (``dc_first_plain``, ``ac_first_plain``,
``ac_refine_plain``) is a lane-vectorized torch state machine with the
reference's steps; kernel 9's is the reference's closed-form band machine
(cumsums, 32-bit rank chunks), while the CUDA kernel runs its serial
form. The wrappers (``dc_first``, ``ac_first``, ``ac_refine``) take the
plain version only for CPU tensors or with ``plain=True``; on CUDA tensors
they launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import bitstream, spans
from ..config import DEFAULT_CONFIG, DecodeConfig
from ..errors import JpegSyntaxError, JpegTruncatedError, JpegUnsupportedError
from ..native import entropy as native_entropy
from . import build
from . import wavefront as wf
from .wavefront import _ERR_BADCODE, _ERR_RUN, _ERR_TRUNC


def scan_kind(scan) -> str:
    """'dc_first', 'dc_refine', 'ac_first' or 'ac_refine'."""
    if scan.ss == 0:
        return "dc_refine" if scan.ah else "dc_first"
    return "ac_refine" if scan.ah else "ac_first"


# ---------------------------------------------------------------------------
# Scan planner
# ---------------------------------------------------------------------------


def _seg_geometry(jpeg, scan) -> Tuple[int, int, int]:
    """(total MCUs, restart interval, segments) of one scan, with the
    reference's checks."""
    frame = jpeg.frame
    if scan.interleaved:
        total = frame.mcus_x * frame.mcus_y
    else:
        c0 = frame.components[scan.comp_indices[0]]
        total = c0.width_blocks * c0.height_blocks
    ri = scan.restart_interval or total
    n_seg = -(-total // ri)
    if len(scan.rst_offsets) + 1 < n_seg:
        raise JpegTruncatedError("missing restart segments")
    if n_seg == 1 and total > 1 and len(scan.data) > wf.MAX_WORDS * 4 - 8:
        raise JpegUnsupportedError("progressive scan without restart segmentation")
    return total, ri, n_seg


def _dest_cached(scan, n_seg) -> bool:
    return (scan.destuffed is not None and scan.dseg_starts is not None
            and len(scan.dseg_starts) >= n_seg + 1)


def _stuffed_width(scan, n_seg) -> int:
    """Words a row needs for the longest segment (exact destuffed lengths
    when parse cached them, the stuffed bound otherwise)."""
    if _dest_cached(scan, n_seg):
        ds = scan.dseg_starts
        lens = ds[1 : n_seg + 1] - ds[:n_seg]
    else:
        ro = np.asarray(scan.rst_offsets[: n_seg - 1], dtype=np.int64)
        lens = np.concatenate([ro, [len(scan.data)]]) - np.concatenate([[0], ro + 2])
    return int(lens.max()) // 4 + 2 if n_seg else 2


def _fill_rows(scan, n_seg, W, out_words, out_bits) -> None:
    """Destuff one scan's segments into W-word rows (the native packer)."""
    if _dest_cached(scan, n_seg):
        native_entropy.rows_from_dest(scan.destuffed, scan.dseg_starts, 0, n_seg, W,
                                      out_words, out_bits)
    else:
        native_entropy.destuff_rows(scan, n_seg, W, out_words, out_bits)


def _table_ids(scan, dc: bool) -> List[Tuple[int, int]]:
    """The (class, id) of the Huffman table each scan component reads."""
    return [(0, scan.dc_ids[sp]) if dc else (1, scan.ac_ids[sp]) for sp in range(scan.n_comps)]


def _tables_for_scan(scan, dc: bool) -> Tuple[wf.CanonTable, ...]:
    out = []
    for key in _table_ids(scan, dc):
        if key not in scan.huff:
            raise JpegSyntaxError("missing Huffman table")
        out.append(wf.CanonTable.from_spec(scan.huff[key]))
    return tuple(out)


# Lanes per CTA of kernels 7-9 (TJ_PROG_THREADS, csrc/prog.cu): a plan
# with more than one table set starts each image's lanes on a multiple.
PROG_THREADS = 128


@dataclasses.dataclass
class ScanPlan:
    """Scan k of a group as flat lanes, one per restart segment, image-major.
    A lane's MCU g places its blocks at block row (g // mcus_x) * v + dv
    and column (g % mcus_x) * h + dh of its component's padded grid; a
    one-component scan has h = v = 1 and mcus_x = width_blocks. The
    tables come in S sets, the group's distinct ones for this scan; with
    S > 1 each image's first lane is a multiple of PROG_THREADS, and the
    lanes between images are padding: no MCUs, the image before them."""

    kind: str                # 'dc_first', 'ac_first' or 'ac_refine'
    bits: torch.Tensor       # int32 [L, W] big-endian words
    seg_bits: torch.Tensor   # int32 [L] destuffed segment length in bits
    lane_meta: torch.Tensor  # int32 [L, 3] (image, first MCU, MCUs)
    tables: torch.Tensor     # int32 [S, n_sp, 34] maxcode[17] | valoffset[17]
    huffval: torch.Tensor    # uint8 [S, n_sp, 256]
    luts: torch.Tensor       # int16 [S, n_sp, 512] 9-bit lookahead (wavefront.lookahead_table)
    image_set: torch.Tensor  # int32 [N] the table set of each image
    comp_indices: Tuple[int, ...]                 # frame component per scan component
    blk: Tuple[Tuple[int, int, int], ...]         # (scan component, dv, dh) per block of an MCU
    comp: Tuple[Tuple[int, int, int, int], ...]   # (h, v, padded_wb, padded_blocks) per scan component
    mcus_x: int
    ss: int
    se: int
    al: int
    n_mcus: int              # most MCUs of any lane
    n_images: int

    @property
    def n_lanes(self) -> int:
        return int(self.lane_meta.shape[0])

    @property
    def n_words(self) -> int:
        return int(self.bits.shape[1])

    @property
    def n_sets(self) -> int:
        return int(self.tables.shape[0])

    @property
    def lane_m(self) -> torch.Tensor:
        return self.lane_meta[:, 2]

    def to(self, device) -> "ScanPlan":
        with spans.span(spans.COPY_IN):
            return dataclasses.replace(
                self, bits=self.bits.to(device), seg_bits=self.seg_bits.to(device),
                lane_meta=self.lane_meta.to(device), tables=self.tables.to(device),
                huffval=self.huffval.to(device), luts=self.luts.to(device),
                image_set=self.image_set.to(device),
            )


@functools.lru_cache(maxsize=64)
def _lookahead(table: wf.CanonTable) -> torch.Tensor:
    """A table's 9-bit lookahead as kernels 7-9 take it (int16: entries are
    at most (9 << 8) | 255), built once per distinct table."""
    return wf.lookahead_table(table).to(torch.int16)


def _table_sets(jpegs, k: int, dc: bool) -> Tuple[List[Tuple[wf.CanonTable, ...]], List[int]]:
    """Scan k's distinct table sets over the group, told apart by their
    bytes, in the order of first use, and each image's set."""
    index: Dict[Tuple, int] = {}
    sets, image_set = [], []
    for j in jpegs:
        scan = j.scans[k]
        key = tuple(_spec_bytes(scan.huff.get(t)) for t in _table_ids(scan, dc))
        if key not in index:
            index[key] = len(sets)
            sets.append(_tables_for_scan(scan, dc))
        image_set.append(index[key])
    return sets, image_set


def _scan_fields(jpegs, k: int) -> dict:
    """The ScanPlan fields that are not lanes: kind, table sets and
    placement (from the group's first image; every image of a group
    places its blocks alike)."""
    scan, frame = jpegs[0].scans[k], jpegs[0].frame
    kind = scan_kind(scan)
    if kind == "dc_refine":
        raise ValueError("a DC refinement scan has no lane plan")
    sets, image_set = _table_sets(jpegs, k, dc=kind == "dc_first")
    if scan.interleaved:
        cis = tuple(scan.comp_indices)
        comps = [frame.components[ci] for ci in cis]
        blk = tuple((sp, dv, dh) for sp, c in enumerate(comps) for dv in range(c.v) for dh in range(c.h))
        comp = tuple((c.h, c.v, c.padded_wb, c.padded_hb * c.padded_wb) for c in comps)
        mcus_x = frame.mcus_x
    else:
        cis = (scan.comp_indices[0],)
        c = frame.components[cis[0]]
        blk = ((0, 0, 0),)
        comp = ((1, 1, c.padded_wb, c.padded_hb * c.padded_wb),)
        mcus_x = c.width_blocks
    return dict(
        kind=kind,
        tables=torch.tensor([[list(t.maxcode) + list(t.valoffset) for t in s] for s in sets], dtype=torch.int32),
        huffval=torch.tensor([[list(t.huffval) for t in s] for s in sets], dtype=torch.uint8),
        luts=torch.stack([torch.stack([_lookahead(t) for t in s]) for s in sets]),
        image_set=torch.tensor(image_set, dtype=torch.int32),
        comp_indices=cis, blk=blk, comp=comp, mcus_x=mcus_x,
        ss=scan.ss, se=scan.se, al=scan.al, n_images=len(jpegs),
    )


def build_scan_plan(jpegs: Sequence, k: int) -> ScanPlan:
    """Lane plan for scan k of every image of a group (one
    ``prog_launch_key``). Raises as the reference's ScanPlan does:
    JpegTruncatedError for missing restart segments, JpegUnsupportedError
    for a one-segment scan over 2040 bytes or a segment over MAX_WORDS
    words."""
    geo = [_seg_geometry(j, j.scans[k]) for j in jpegs]
    W = 2
    for j, (_total, _ri, n_seg) in zip(jpegs, geo):
        W = max(W, _stuffed_width(j.scans[k], n_seg))
    W = min(-(-W // 32) * 32, wf.MAX_WORDS + 32)
    if W > wf.MAX_WORDS:
        raise JpegUnsupportedError(f"progressive segment too long ({W} words)")
    fields = _scan_fields(jpegs, k)
    # One table set: lanes back to back. Several: each image from a CTA
    # boundary on, so that no CTA holds lanes of two sets.
    align = PROG_THREADS if fields["tables"].shape[0] > 1 else 1
    starts = np.cumsum([0] + [-(-n_seg // align) * align for _t, _r, n_seg in geo])
    L = int(starts[-2]) + geo[-1][2]
    bits = np.zeros((L, W), dtype=np.int32)
    seg_bits = np.zeros(L, dtype=np.int32)
    meta = np.zeros((L, 3), dtype=np.int32)
    for ii, (j, (total, ri, n_seg)) in enumerate(zip(jpegs, geo)):
        lane0, end = int(starts[ii]), min(int(starts[ii + 1]), L)
        _fill_rows(j.scans[k], n_seg, W, bits[lane0 : lane0 + n_seg], seg_bits[lane0 : lane0 + n_seg])
        fm = np.arange(n_seg, dtype=np.int64) * ri
        meta[lane0:end, 0] = ii
        meta[lane0 : lane0 + n_seg, 1] = fm
        meta[lane0 : lane0 + n_seg, 2] = np.minimum(ri, total - fm)
    return ScanPlan(
        bits=torch.from_numpy(bits), seg_bits=torch.from_numpy(seg_bits),
        lane_meta=torch.from_numpy(meta), n_mcus=int(meta[:, 2].max()) if L else 0,
        **fields,
    )


def scan_plan_from_reference(ref_plan, jpegs: Sequence, k: int) -> ScanPlan:
    """The reference's ScanPlan (numpy, [G, 8, K, ...] lane groups) for scan
    k of `jpegs` (parsed by this package) as the port's plan: lane groups
    flattened and trimmed to the real lane count. Lets a test feed the
    identical lanes to both decoders."""
    L, W = ref_plan.n_lanes, ref_plan.n_words
    return ScanPlan(
        bits=torch.from_numpy(np.ascontiguousarray(np.asarray(ref_plan.bits).reshape(-1, W)[:L])),
        seg_bits=torch.from_numpy(
            np.ascontiguousarray(np.asarray(ref_plan.seg_bits).reshape(-1)[:L]).astype(np.int32)),
        lane_meta=torch.from_numpy(np.asarray(ref_plan.lane_meta, np.int32)),
        n_mcus=ref_plan.n_mcus,
        **_scan_fields(jpegs, k),
    )


# ---------------------------------------------------------------------------
# Plain versions of kernels 7, 8 and 9
# ---------------------------------------------------------------------------


def _receive_raw(win: torch.Tensor, length: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The `n` raw bits after a `length`-bit code in the window (no EXTEND)."""
    after = (win << length) & 0xFFFFFFFF
    return torch.where(n > 0, after >> (32 - n), 0)


def _lane_decoder(plan: ScanPlan, sp: int):
    """decode(win) -> (symbol, code length) for every lane, each with table
    sp of its image's set: ``wavefront._decode_symbol`` with per-lane
    maxcodes, value offsets and symbol lists."""
    tab = plan.tables[:, sp].to(torch.int64)                                 # [S, 34]
    lane_set = plan.image_set.to(torch.int64)[plan.lane_meta[:, 0].to(torch.int64)]
    mc = tab[lane_set, :17].T.contiguous()                                    # [17, L]
    vo = tab[lane_set, 17:].T.contiguous()
    hv = plan.huffval[:, sp].to(torch.int64).reshape(-1)
    base = lane_set * 256
    lengths = [l for l in range(16, 0, -1) if bool((tab[:, l] >= 0).any())]

    def decode(win):
        length = torch.full_like(win, 17)
        idx = torch.zeros_like(win)
        for l in lengths:
            peek = win >> (32 - l)
            sel = peek <= mc[l]
            length = torch.where(sel, l, length)
            idx = torch.where(sel, peek + vo[l], idx)
        return hv[base + idx.clamp(0, 255)], length

    return decode


def _lane_vectors(plan: ScanPlan):
    img = plan.lane_meta[:, 0].to(torch.int64)
    first = plan.lane_meta[:, 1].to(torch.int64)
    lane_m = plan.lane_meta[:, 2].to(torch.int64)
    return img, first, lane_m


def _finish_err(plan: ScanPlan, cur, e, lane_m, err: torch.Tensor) -> None:
    trunc = (cur > plan.seg_bits.to(torch.int64) + 7) & (lane_m > 0)
    err.copy_((e | torch.where(trunc, _ERR_TRUNC, 0)).to(torch.int32))


def _block_index(plan: ScanPlan, img, g):
    """Flat block index into a one-component scan's [N, padded_blocks]."""
    _h, _v, pwb, nb = plan.comp[0]
    return img * nb + (g // plan.mcus_x) * pwb + g % plan.mcus_x


def dc_first_plain(plan: ScanPlan, cols: Sequence[torch.Tensor], err: torch.Tensor) -> None:
    """Kernel 7's plain version: every lane one MCU and block at a time.
    cols[sp]: the int32 [N, padded_blocks] DC column of scan component sp;
    err: int32 [L] error bits out."""
    dev = plan.bits.device
    L = plan.n_lanes
    window = wf.lane_windows(plan.bits)
    decoders = [_lane_decoder(plan, sp) for sp in range(len(plan.comp))]
    img, first, lane_m = _lane_vectors(plan)
    flat = [c.view(-1) for c in cols]
    cur = torch.zeros(L, dtype=torch.int64, device=dev)
    e = torch.zeros_like(cur)
    pred = torch.zeros(len(plan.comp), L, dtype=torch.int64, device=dev)
    for m in range(plan.n_mcus):
        active = m < lane_m
        g = first + m
        my, mx = g // plan.mcus_x, g % plan.mcus_x
        for sp, dv, dh in plan.blk:
            ok = active & (e == 0)
            win = window(cur)
            t, dlen = decoders[sp](win)
            bad = ok & ((dlen > 16) | (t > 15))
            t = torch.where(t > 15, 0, t)
            pred[sp] = pred[sp] + torch.where(ok, wf._receive_extend(win, dlen, t), 0)
            cur = cur + torch.where(ok, dlen + t, 0)
            e = torch.where(bad, _ERR_BADCODE, e)
            h, v, pwb, nb = plan.comp[sp]
            idx = img * nb + (my * v + dv) * pwb + mx * h + dh
            out = torch.where(ok, pred[sp] << plan.al, 0).to(torch.int32)
            flat[sp][idx[active]] = out[active]
    _finish_err(plan, cur, e, lane_m, err)


def ac_first_plain(plan: ScanPlan, state: torch.Tensor, err: torch.Tensor) -> None:
    """Kernel 8's plain version: per MCU, an EOB run skips the block,
    otherwise a symbol loop masked per lane adds val << Al into state
    (int32 [N, padded_blocks, 64]) at the zigzag slot."""
    dev = plan.bits.device
    L = plan.n_lanes
    ss, se, al = plan.ss, plan.se, plan.al
    window = wf.lane_windows(plan.bits)
    decode = _lane_decoder(plan, 0)
    img, first, lane_m = _lane_vectors(plan)
    flat = state.view(-1)
    cur = torch.zeros(L, dtype=torch.int64, device=dev)
    e = torch.zeros_like(cur)
    eob = torch.zeros_like(cur)
    for m in range(plan.n_mcus):
        ok = (m < lane_m) & (e == 0)
        skip = ok & (eob > 0)
        eob = torch.where(skip, eob - 1, eob)
        busy0 = ok & ~skip
        base = _block_index(plan, img, first + m) * 64
        k = torch.where(busy0, ss, 65)
        busy = busy0 & (k <= se)
        while bool(busy.any()):
            win = window(cur)
            rs, alen = decode(win)
            r, s = rs >> 4, rs & 0x0F
            val = wf._receive_extend(win, alen, s)
            is_eob = (s == 0) & (r < 15)
            is_zrl = (s == 0) & (r == 15)
            nk = k + torch.where(s > 0, r, 0)
            over = busy & (s > 0) & (nk > se)
            emit = busy & (s > 0) & (nk <= se)
            flat.index_add_(0, (base + nk)[emit], (val << al)[emit].to(torch.int32))
            extra = _receive_raw(win, alen, torch.where(is_eob, r, 0))
            eob = torch.where(busy & is_eob, (1 << r) - 1 + extra, eob)
            consumed = alen + torch.where(s > 0, s, torch.where(is_eob, r, 0))
            cur = cur + torch.where(busy, consumed, 0)
            k = torch.where(busy, torch.where(is_eob, 65, torch.where(is_zrl, k + 16, nk + 1)), k)
            e = torch.where(busy & (alen > 16), _ERR_BADCODE, e)
            e = torch.where(over, _ERR_RUN, e)
            busy = busy0 & (k <= se) & (e == 0)
    _finish_err(plan, cur, e, lane_m, err)


_MODE_SYMBOL, _MODE_RANGE, _MODE_DONE = 0, 1, 2


def ac_refine_plain(plan: ScanPlan, state: torch.Tensor, err: torch.Tensor) -> None:
    """Kernel 9's plain version: the reference's closed-form band machine.
    Per MCU, each lane's block (a row of state, int32 [N, padded_blocks,
    64]) is gathered; each substep decodes one symbol for lanes that need
    one (finding the stop with a cumsum over the band), then applies up to
    32 correction bits of the open range by rank; the band goes back when
    every lane is done. A block takes at most about 64 substeps (k grows
    with every symbol), so the reference's trip cap never binds."""
    dev = plan.bits.device
    L = plan.n_lanes
    ss, se = plan.ss, plan.se
    p1, m1 = 1 << plan.al, -(1 << plan.al)
    window = wf.lane_windows(plan.bits)
    decode = _lane_decoder(plan, 0)
    img, first, lane_m = _lane_vectors(plan)
    rows = state.view(-1, 64)
    kio = torch.arange(64, device=dev)[None, :]
    cur = torch.zeros(L, dtype=torch.int64, device=dev)
    e = torch.zeros_like(cur)
    eob = torch.zeros_like(cur)

    def full(v):
        return torch.full((L,), v, dtype=torch.int64, device=dev)

    for m in range(plan.n_mcus):
        active = m < lane_m
        ok = active & (e == 0)
        row = torch.where(active, _block_index(plan, img, first + m), 0)
        cv = rows[row]
        entry_tail = ok & (eob > 0)
        mode = torch.where(ok, torch.where(entry_tail, _MODE_RANGE, _MODE_SYMBOL), _MODE_DONE)
        k, kstop = full(ss), full(se + 1)
        place, done = full(0), full(0)
        tail = entry_tail.to(torch.int64)
        while bool((mode != _MODE_DONE).any()):
            # Symbol decode (mode SYMBOL).
            dec = mode == _MODE_SYMBOL
            win = window(cur)
            rs, alen = decode(win)
            badc = dec & (alen > 16)
            rr, ds = rs >> 4, rs & 0x0F
            bads = dec & (ds > 1)
            sign = _receive_raw(win, alen, torch.where(ds > 0, 1, 0))
            nval = torch.where(sign > 0, p1, m1)
            is_eob = (ds == 0) & (rr < 15)
            extra = _receive_raw(win, alen, torch.where(is_eob, rr, 0))
            dec_bits = alen + torch.where(ds > 0, 1, torch.where(is_eob, rr, 0))
            cur1 = cur + torch.where(dec, dec_bits, 0)
            eob = torch.where(dec & is_eob, (1 << rr) + extra, eob)
            # Stop: the (r+1)-th zero at or after k (16th for ZRL); run
            # lanes count zeros in [k, se], the others nonzeros in
            # [k, kstop).
            run = dec & ~is_eob
            in_lo = kio >= k[:, None]
            kstop_eff = torch.where(dec, se + 1, kstop)
            mask = (((cv == 0) ^ ~run[:, None]) & in_lo & (kio < kstop_eff[:, None])).to(torch.int64)
            mcum = torch.cumsum(mask, dim=1)
            row_se = mcum[:, se]
            target = torch.where(ds > 0, rr + 1, 16)
            kstop_found = (mcum < target[:, None]).sum(dim=1)
            notfound = kstop_found >= 64
            e = torch.where(badc | bads, _ERR_BADCODE, e)
            e = torch.where(run & (ds > 0) & notfound, _ERR_RUN, e)
            kstop = torch.where(dec, torch.where(run & ~notfound, kstop_found, se + 1), kstop)
            place = torch.where(dec, torch.where((ds > 0) & ~notfound, nval, 0), place)
            tail = torch.where(dec, is_eob.to(torch.int64), tail)
            done = torch.where(dec, 0, done)
            mode = torch.where(dec, _MODE_RANGE, mode)
            total_nz = torch.where(
                run, torch.where(notfound, (se + 1 - k) - row_se, kstop - k - (target - 1)), row_se)
            # Correction bits: ranks [done, done + 32) of the range's
            # nonzeros take the window's bits MSB first.
            rng = (mode == _MODE_RANGE) & (e == 0)
            win2 = window(cur1)
            nz_j = (cv != 0) & in_lo & (kio < kstop[:, None])
            ncum = torch.where(run[:, None], (kio - k[:, None] + 1) - mcum, mcum)
            rank = ncum - 1 - done[:, None]
            in_chunk = nz_j & rng[:, None] & (rank >= 0) & (rank < 32)
            bit = (win2[:, None] >> (31 - rank.clamp(0, 31))) & 1
            do_fix = in_chunk & (bit > 0) & ((cv & p1) == 0)
            left = total_nz - done
            complete = rng & (left <= 32)
            placing = complete & (place != 0)
            add = (torch.where(do_fix, torch.where(cv >= 0, p1, m1), 0)
                   + torch.where((kio == kstop[:, None]) & placing[:, None], place[:, None], 0))
            cv = (cv.to(torch.int64) + add).to(torch.int32)
            cur = cur1 + torch.where(rng, left.clamp(0, 32), 0)
            done = torch.where(rng & ~complete, done + 32, done)
            k = torch.where(complete, kstop + 1, k)
            eob = torch.where(complete & (tail > 0), eob - 1, eob)
            mode = torch.where(
                complete, torch.where((tail > 0) | (k > se), _MODE_DONE, _MODE_SYMBOL), mode)
            mode = torch.where(e != 0, _MODE_DONE, mode)
        rows[row[ok]] = cv[ok]
    _finish_err(plan, cur, e, lane_m, err)


# ---------------------------------------------------------------------------
# Kernel 7, 8 and 9 wrappers
# ---------------------------------------------------------------------------


def _lane_specs(plan: ScanPlan, err: torch.Tensor):
    return [(plan.bits, torch.int32, 2), (plan.seg_bits, torch.int32, 1),
            (plan.lane_meta, torch.int32, 2), (plan.tables, torch.int32, 3),
            (plan.huffval, torch.uint8, 3), (plan.luts, torch.int16, 3),
            (plan.image_set, torch.int32, 1), (err, torch.int32, 1)]


def _check_state(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: state {tuple(t.shape)}, want {shape}")


def _plain_or_launch(name: str, dev: torch.device, plain: bool) -> bool:
    """True when the plain version runs: asked for, or tensors on the CPU."""
    if plain or dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no path for device {dev}")
    return False


def _row_args(plan: ScanPlan):
    W = plan.n_words
    return (plan.bits.data_ptr(), W, 1 << max(W - 1, 1).bit_length(),
            plan.seg_bits.data_ptr(), plan.lane_meta.data_ptr(), plan.n_lanes,
            plan.tables.data_ptr(), plan.huffval.data_ptr(), plan.luts.data_ptr(),
            plan.image_set.data_ptr(), plan.n_sets)


def dc_first(plan: ScanPlan, dcs: Sequence[torch.Tensor], err: torch.Tensor, *,
             plain: bool = False) -> None:
    """Kernel 7: a DC first scan into the frame's DC columns (dcs[ci]: int32
    [N, padded_blocks] per frame component, on the plan's device); the
    scan's components' columns take pred << Al. err: int32 [L] out."""
    cols = [dcs[ci] for ci in plan.comp_indices]
    for c, (_h, _v, _pwb, nb) in zip(cols, plan.comp):
        _check_state("prog_dc_first", c, (plan.n_images, nb))
    if len(cols) == 1:
        # A one-component scan stores only the blocks of the component's
        # own grid, and the reference sets the whole padded column: clear
        # it first, so that the pad blocks read 0 as there.
        cols[0].zero_()
    dev = plan.bits.device
    if _plain_or_launch("prog_dc_first", dev, plain):
        return dc_first_plain(plan, cols, err)
    build.check_args("prog_dc_first", dev, _lane_specs(plan, err) + [(c, torch.int32, 2) for c in cols])
    build.check_aligned("prog_dc_first", [plan.bits, plan.luts])  # read as int4
    if len(plan.blk) > 10 or len(cols) > 4:
        raise ValueError(f"prog_dc_first: {len(plan.blk)} blocks per MCU, {len(cols)} components")
    blk = np.ascontiguousarray(plan.blk, dtype=np.int32)
    comp = np.ascontiguousarray(plan.comp, dtype=np.int32)
    ptrs = [c.data_ptr() for c in cols] + [None] * (4 - len(cols))
    rc = build.call(
        dev, "tj_prog_dc_first", *_row_args(plan), len(cols), blk.ctypes.data, len(plan.blk),
        comp.ctypes.data, plan.mcus_x, plan.al, *ptrs, err.data_ptr())
    build.raise_on_error(rc, "prog_dc_first")
    build.launched("prog_dc_first")
    spans.count(spans.PROG_TSETS, plan.n_sets)


def _launch_ac(name: str, plan: ScanPlan, state: torch.Tensor, err: torch.Tensor) -> None:
    dev = plan.bits.device
    build.check_args(name, dev, _lane_specs(plan, err) + [(state, torch.int32, 3)])
    # Kernel 9 moves each block as 16 int4, both read their tables as
    # int4 and kernel 8 its rows; the C entries refuse them off a 16-byte
    # boundary.
    build.check_aligned(name, [state, plan.bits, plan.luts])
    _h, _v, pwb, nb = plan.comp[0]
    rc = build.call(
        dev, "tj_" + name, *_row_args(plan), plan.mcus_x, pwb, nb, plan.ss, plan.se, plan.al,
        state.data_ptr(), err.data_ptr())
    build.raise_on_error(rc, name)
    build.launched(name)
    spans.count(spans.PROG_TSETS, plan.n_sets)


def ac_first(plan: ScanPlan, state: torch.Tensor, err: torch.Tensor, *, plain: bool = False) -> None:
    """Kernel 8: an AC first scan added into state, the int32
    [N, padded_blocks, 64] AC array of the scan's component (on the card,
    starting on a 16-byte boundary). err: int32 [L] out."""
    _check_state("prog_ac_first", state, (plan.n_images, plan.comp[0][3], 64))
    if _plain_or_launch("prog_ac_first", plan.bits.device, plain):
        return ac_first_plain(plan, state, err)
    _launch_ac("prog_ac_first", plan, state, err)


def ac_refine(plan: ScanPlan, state: torch.Tensor, err: torch.Tensor, *, plain: bool = False) -> None:
    """Kernel 9: an AC refinement scan applied to state in place (as
    ``ac_first``; on the card, state must start on a 16-byte boundary)."""
    _check_state("prog_ac_refine", state, (plan.n_images, plan.comp[0][3], 64))
    if _plain_or_launch("prog_ac_refine", plan.bits.device, plain):
        return ac_refine_plain(plan, state, err)
    _launch_ac("prog_ac_refine", plan, state, err)


# ---------------------------------------------------------------------------
# DC refinement: host masks + device OR
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DcRefine:
    """A DC refinement scan of a group: per scan component, the frame
    component it refines and an int32 [N, padded_blocks] OR mask (the
    correction bit already at position Al)."""

    comp_indices: Tuple[int, ...]
    masks: List[torch.Tensor]


def _dc_refine_masks(jpeg, scan) -> List[Tuple[int, np.ndarray]]:
    """One correction bit per block at a fixed position, so no kernel: the
    bits unpack on the host into per-component [padded_blocks] int32
    masks. Raises JpegTruncatedError where a segment is short, as the
    reference does."""
    frame = jpeg.frame
    total, ri, n_seg = _seg_geometry(jpeg, scan)
    pieces = bitstream.split_restart_segments(scan)
    bpm = (sum(frame.components[ci].h * frame.components[ci].v for ci in scan.comp_indices)
           if scan.interleaved else 1)
    bits_all = []
    mcu = 0
    for seg in pieces[:n_seg]:
        need = min(ri, total - mcu) * bpm
        got = np.unpackbits(np.frombuffer(seg, np.uint8))
        if len(got) < need:
            raise JpegTruncatedError("DC refinement scan truncated")
        bits_all.append(got[:need])
        mcu += min(ri, total - mcu)
    bits_np = np.concatenate(bits_all) if bits_all else np.zeros(0, np.uint8)
    p1 = 1 << scan.al
    masks: List[Tuple[int, np.ndarray]] = []
    if scan.interleaved:
        # MCU-major, block-within-MCU minor.
        per_mcu = bits_np.reshape(total, bpm)
        b0 = 0
        for ci in scan.comp_indices:
            c = frame.components[ci]
            sub = per_mcu[:, b0 : b0 + c.h * c.v]
            b0 += c.h * c.v
            sub = sub.reshape(frame.mcus_y, frame.mcus_x, c.v, c.h).transpose(0, 2, 1, 3)
            masks.append((ci, sub.reshape(c.padded_hb * c.padded_wb).astype(np.int32) * p1))
    else:
        ci = scan.comp_indices[0]
        c = frame.components[ci]
        grid = np.zeros((c.padded_hb, c.padded_wb), np.int32)
        grid[: c.height_blocks, : c.width_blocks] = bits_np.reshape(c.height_blocks, c.width_blocks)
        masks.append((ci, grid.reshape(-1) * p1))
    return masks


def build_dc_refine(jpegs: Sequence, k: int) -> DcRefine:
    per_image = [_dc_refine_masks(j, j.scans[k]) for j in jpegs]
    cis = tuple(ci for ci, _m in per_image[0])
    return DcRefine(cis, [torch.from_numpy(np.stack([m[sp][1] for m in per_image]))
                          for sp in range(len(cis))])


# ---------------------------------------------------------------------------
# Scan driver
# ---------------------------------------------------------------------------


def scan_group_key(jpeg) -> Tuple:
    """The reference's group key: the same frame geometry and an identical
    scan script (kind, band, successive approximation bits, components,
    and the bytes of each Huffman table a kernel reads). Restart intervals
    and segment lengths may differ. The port groups by the coarser
    ``prog_launch_key``; this key stays the reference's, for those who
    group as it does."""
    frame = jpeg.frame
    parts: list = [frame.height, frame.width, tuple((c.h, c.v) for c in frame.components)]
    for scan in jpeg.scans:
        kind = scan_kind(scan)
        if kind == "dc_refine":
            tabs: Tuple = ()
        elif kind == "dc_first":
            tabs = tuple(_spec_bytes(scan.huff.get((0, scan.dc_ids[sp]))) for sp in range(scan.n_comps))
        else:
            tabs = (_spec_bytes(scan.huff.get((1, scan.ac_ids[0]))),)
        parts.append((scan.interleaved, tuple(scan.comp_indices), scan.ss, scan.se, scan.ah,
                      scan.al, tabs))
    return tuple(parts)


def _spec_bytes(spec) -> Optional[bytes]:
    if spec is None:
        return None
    return spec.counts.tobytes() + spec.values.tobytes()


def prog_launch_key(jpeg) -> Tuple:
    """Images whose keys match share each scan kernel's launch: the same
    frame geometry and sampling and an identical scan script (interleaving,
    components, band, successive approximation bits). Unlike
    ``scan_group_key`` it leaves out the Huffman tables: a plan carries
    one table set per distinct set of its images."""
    frame = jpeg.frame
    return (frame.height, frame.width, tuple((c.h, c.v) for c in frame.components),
            tuple((s.interleaved, tuple(s.comp_indices), s.ss, s.se, s.ah, s.al) for s in jpeg.scans))


def check_group(jpegs: Sequence) -> None:
    """Raise JpegUnsupportedError unless `jpegs` is a non-empty group of
    progressive frames with one prog_launch_key."""
    if not jpegs:
        raise JpegUnsupportedError("empty group")
    for j in jpegs:
        if not j.frame.progressive:
            raise JpegUnsupportedError("not a progressive frame")
    key0 = prog_launch_key(jpegs[0])
    if any(prog_launch_key(j) != key0 for j in jpegs[1:]):
        raise JpegUnsupportedError(
            "progressive group with different frames or scan scripts: "
            "decode its images in separate groups")


ScanStep = Union[ScanPlan, DcRefine]


def plan_scans(jpegs: Sequence) -> List[ScanStep]:
    """The host work of a group's decode: per scan, a lane plan (kernel
    scans) or the OR masks (DC refinement). Raises on streams the
    reference rejects, and JpegUnsupportedError for a mixed group."""
    with spans.span(spans.PLAN):
        check_group(jpegs)
        return [build_dc_refine(jpegs, k) if scan_kind(s) == "dc_refine" else build_scan_plan(jpegs, k)
                for k, s in enumerate(jpegs[0].scans)]


def new_state(frame, n: int, device) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Zeroed batch state: per frame component, int32 [n, padded_blocks, 64]
    AC and int32 [n, padded_blocks] DC on `device`."""
    nbs = [c.padded_hb * c.padded_wb for c in frame.components]
    return ([torch.zeros((n, nb, 64), dtype=torch.int32, device=device) for nb in nbs],
            [torch.zeros((n, nb), dtype=torch.int32, device=device) for nb in nbs])


def apply_step(step: ScanStep, acs: List[torch.Tensor], dcs: List[torch.Tensor], *,
               plain: bool = False) -> Optional[Tuple[torch.Tensor, ScanPlan]]:
    """Apply one planned scan to the batch state in place. Returns
    (error bits int32 [L], the plan on the state's device) for a kernel
    scan, None for a DC refinement."""
    dev = acs[0].device
    if isinstance(step, DcRefine):
        for ci, mask in zip(step.comp_indices, step.masks):
            with spans.span(spans.COPY_IN):
                mask = mask.to(dev)
            dcs[ci] |= mask
        return None
    plan = step.to(dev)
    err = torch.zeros(plan.n_lanes, dtype=torch.int32, device=dev)
    if plan.kind == "dc_first":
        dc_first(plan, dcs, err, plain=plain)
    elif plan.kind == "ac_first":
        ac_first(plan, acs[plan.comp_indices[0]], err, plain=plain)
    else:
        ac_refine(plan, acs[plan.comp_indices[0]], err, plain=plain)
    return err, plan


def apply_scan_batch(jpegs: Sequence, k: int, acs: List[torch.Tensor], dcs: List[torch.Tensor],
                     plan: Optional[ScanPlan] = None) -> Optional[Tuple[torch.Tensor, ScanPlan]]:
    """Apply scan k of every image of the group to the batch state
    (acs[ci]: int32 [N, padded_blocks, 64], dcs[ci]: int32 [N,
    padded_blocks], on one device), in place. Returns (error bits, plan)
    of a kernel scan, for ``resolve_scan_errors``, and None for a DC
    refinement. `plan` (a kernel scan's) may come from ``build_scan_plan``
    or ``scan_plan_from_reference``."""
    check_group(jpegs)
    if scan_kind(jpegs[0].scans[k]) == "dc_refine":
        return apply_step(build_dc_refine(jpegs, k), acs, dcs)
    return apply_step(plan if plan is not None else build_scan_plan(jpegs, k), acs, dcs)


def run_scans(frame, n: int, steps: Sequence[ScanStep], device):
    """Every planned scan of a group of `n` images, in order, from a zeroed
    state. Returns (acs, dcs, errs, kernel_plans): the state, and the
    error bits and plan of each kernel scan."""
    acs, dcs = new_state(frame, n, device)
    errs, kernel_plans = [], []
    for step in steps:
        res = apply_step(step, acs, dcs)
        if res is not None:
            errs.append(res[0])
            kernel_plans.append(res[1])
    return acs, dcs, errs, kernel_plans


def resolve_scan_errors(errs: Sequence[torch.Tensor], kernel_plans: Sequence[ScanPlan]
                        ) -> Dict[int, Exception]:
    """Read the scans' error bits back (one copy) and map them to
    per-image failures: the first failing scan of an image wins."""
    failures: Dict[int, Exception] = {}
    if not errs:
        return failures
    with spans.span(spans.CARD_WAIT):
        flat = torch.cat(list(errs)).cpu().numpy()
        metas = [plan.lane_meta.cpu().numpy() for plan in kernel_plans]
    lane0 = 0
    for plan, meta in zip(kernel_plans, metas):
        e = flat[lane0 : lane0 + plan.n_lanes]
        lane0 += plan.n_lanes
        for img, exc in wf.failures_from_err(e, meta).items():
            failures.setdefault(img, exc)
    return failures


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------


def decode_all_scans_batch(
    jpegs: Sequence, device="cuda"
) -> Tuple[List[Optional[List[torch.Tensor]]], List[Optional[List[torch.Tensor]]], Dict[int, Exception]]:
    """Progressive entropy decode of a group (one ``prog_launch_key``) on
    `device`: scan k of every image in one launch. Returns (states, dcs,
    failures): states[i] is image i's per-component int32 [padded_blocks,
    64] zigzag AC (column 0 zero) and dcs[i] its int32 [padded_blocks] DC
    columns, views of the batch state, or None where failures[i] holds
    its exception. The error bits are read back once, at the end."""
    steps = plan_scans(jpegs)
    acs, dcs, errs, kernel_plans = run_scans(jpegs[0].frame, len(jpegs), steps, torch.device(device))
    failures = resolve_scan_errors(errs, kernel_plans)
    states = [None if i in failures else [a[i] for a in acs] for i in range(len(jpegs))]
    dc_out = [None if i in failures else [d[i] for d in dcs] for i in range(len(jpegs))]
    return states, dc_out, failures


def decode_all_scans_to_rgb_batch(jpegs: Sequence, config: DecodeConfig = DEFAULT_CONFIG,
                                  packed: bool = False, defer_errors: bool = False, device="cuda"):
    """Full progressive decode of a group on `device`: every scan (kernels
    7-9 and the DC-refine ORs), then ``pipeline.transform_batch`` with the
    DC columns (kernel 6, then the color stage), with per-image [N, 64]
    quantizers when the images' differ. Returns (rgb, layout, failures):
    uint8 [N, H, W, 3] (or [N, H, W] gray) on `device` with layout "nhwc",
    or with `packed`, where ``pipeline.packed_layout_applies``, planar
    uint16 [N, 3, H, W/2] with layout "packed16"; image i is garbage when
    failures has i. With `defer_errors` the third element is instead the
    (error bits, kernel plans) pair for ``resolve_scan_errors``: nothing is
    read back, so a caller can launch several groups before it waits."""
    from . import pipeline

    device = torch.device(device)
    steps = plan_scans(jpegs)
    frame = jpegs[0].frame
    color = bitstream.color_space(jpegs[0])
    acs, dcs, errs, kernel_plans = run_scans(frame, len(jpegs), steps, device)
    qsets = {tuple(j.qtables[c.tq].tobytes() for c in frame.components) for j in jpegs}
    if len(qsets) > 1:
        qtabs = [np.stack([j.qtables[c.tq] for j in jpegs]) for c in frame.components]
    else:
        qtabs = [jpegs[0].qtables[c.tq] for c in frame.components]
    qtabs = [torch.from_numpy(np.ascontiguousarray(q, dtype=np.int32)).to(device) for q in qtabs]
    rgb = pipeline.transform_batch(frame, acs, qtabs, config, color=color, dcs=dcs, packed=packed)
    layout = pipeline.layout_of(rgb)
    if defer_errors:
        return rgb, layout, (errs, kernel_plans)
    return rgb, layout, resolve_scan_errors(errs, kernel_plans)


def decode_all_scans(jpeg, device="cuda") -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One progressive image on `device`. Returns (acs, dcs): per frame
    component int32 [padded_blocks, 64] zigzag AC (column 0 zero) and
    int32 [padded_blocks] DC. Raises the image's failure."""
    states, dcs, failures = decode_all_scans_batch([jpeg], device)
    if failures:
        raise failures[0]
    return states[0], dcs[0]
