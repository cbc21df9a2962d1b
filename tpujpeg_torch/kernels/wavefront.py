"""Baseline decode with lanes of whole restart segments, or of pieces of
a scan cut at skeleton-scan bit offsets: Huffman + dequant + islow IDCT
straight to raster component planes (kernel A), or Huffman to zigzag
coefficient blocks at their raster block index (kernel 2).

Port of ``tpujpeg/kernels/wavefront_pallas.py``'s baseline paths: the
lane planners (``build_block_plan`` for restart segments,
``build_norst_plan`` for marker-free scans and restart intervals over
the row cap, with its host skeleton split ``_scan_split_host`` and the
plain walk ``_skeleton_walk_py``), the per-lane error mapping
(``failures_from_err``/``resolve_rgb_errors``), the ``_make_kernel``
Pallas kernel with ``emit="pixels"`` and ``emit="coeff"``, which become
the CUDA kernels ``tj_wavefront_pixels`` and ``tj_wavefront_coeff`` in
``csrc/wavefront.cu`` (``lookahead_table`` is the plain form of their
9-bit lookahead rule; a norst lane starts at its ``bit0`` with its DC
predictors primed from ``dc0``), and the entries:
``decode_batch_to_coeffs`` (the batch layout kernel 6 takes),
``decode_batch_to_device`` (the reference's per-image split of it),
``decode_norst_to_device``, ``decode_norst_to_rgb``,
``decode_multiscan_to_device`` and ``decode_all_scans``, the wavefront
entropy engine of ``decode()``, which hands progressive frames to
``wavefront_prog`` (kernels 7-9) and streams the restart plan refuses to
the norst plan, as the reference's does. The plain version of both
kernels, ``decode_lanes_plain``, is a lane-vectorized torch state machine
with the same steps as the Pallas kernel; the wrappers
``decode_lanes_to_planes`` and ``decode_lanes_to_coeffs`` take it only
for tensors on the CPU. ``plan_launches`` plans the stream's and the batch
ladder's kernel-A launches: geometry buckets (``bucket_key``), a restart
plan each, and buckets that share what kernel A takes by value
(``launch_key``) combined into one plan for its mixed form
(``combine_plans``: rows padded to the widest, a geometry row per image,
one flat output per plane); every restart or norst plan reaches RGB
through ``decode_group_to_rgb`` and its errors through
``resolve_rgb_errors``. The reference has no launch groups (its stream
falls back on mixed chunks).

The TPU layout does not carry over: lanes are a flat [L] axis (no
[G, 8, K] sublane groups), each lane reads its own row of words from
device memory, and the kernels store samples or coefficient blocks at
their raster positions, so there is no assembly pass. The planners still
keep the reference's scope (row width rule, ``MAX_WORDS``, the norst
split's default ``every``, one table set per batch; ``MAX_QSETS`` in the
fused entry) so that both decoders accept and reject the same streams.
One difference is kept: on a CUDA device ``decode_norst_to_rgb`` splits a
scan into one wave of kernel A's lanes (``card_norst_plan``), with rows in
4-word steps, since a lane's serial chain, not the card's bandwidth, bounds
the kernel there; it starts at a smaller ``every`` under the same halving
cap, so it may accept a stream whose lanes the reference's split gives up
on, and decodes it byte-exact.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import bitstream, spans
from .. import transform as T
from ..config import DEFAULT_CONFIG, DecodeConfig
from ..errors import JpegError, JpegHuffmanError, JpegSyntaxError, JpegTruncatedError, JpegUnsupportedError
from ..native import entropy as native_entropy
from . import build

MAX_WORDS = 512   # per-lane row cap, the reference's (a longer segment takes the norst plan)
MAX_QSETS = 8     # distinct quantizer sets per batch, the reference's

_ERR_BADCODE = 1
_ERR_RUN = 2
_ERR_TRUNC = 4

@dataclasses.dataclass(frozen=True)
class CanonTable:
    """Canonical decode constants for one Huffman table (T.81 F.2.2.3):
    maxcode / valoffset per code length and the symbol list."""

    maxcode: Tuple[int, ...]    # [17], -1 where no codes
    valoffset: Tuple[int, ...]  # [17]
    huffval: Tuple[int, ...]    # [256], zero padded

    @staticmethod
    def from_spec(spec) -> "CanonTable":
        maxcode = [-1] * 17
        valoffset = [0] * 17
        code = 0
        k = 0
        for l in range(1, 17):
            n = int(spec.counts[l - 1])
            if n:
                valoffset[l] = k - code
                code += n
                k += n
                maxcode[l] = code - 1
            code <<= 1
        hv = [int(v) for v in spec.values] + [0] * (256 - len(spec.values))
        return CanonTable(tuple(maxcode), tuple(valoffset), tuple(hv))


@dataclasses.dataclass(frozen=True)
class ImageGeom:
    """The frame and first-scan geometry that places a lane's blocks."""

    frame: object
    interleaved: bool
    comp_indices: Tuple[int, ...]
    restart_interval: int

    @classmethod
    def of(cls, jpeg) -> "ImageGeom":
        s = jpeg.scans[0]
        return cls(jpeg.frame, s.interleaved, tuple(s.comp_indices), s.restart_interval)


@dataclasses.dataclass
class LanePlan:
    """One uniform batch as flat lanes: one lane per restart segment, or
    (``build_norst_plan``, one image) one per `norst_every` MCUs of a
    scan, starting at bit ``bit0`` of its row with its DC predictors
    primed from ``dc0``. The norst fields are None (0) in a restart plan,
    whose lanes start at bit 0 with zero predictors."""

    bits: torch.Tensor       # int32[L, W] big-endian words, 0xFF padded
    seg_bits: torch.Tensor   # int32[L] destuffed segment length in bits
    lane_m: torch.Tensor     # int32[L] MCUs in the lane
    lane_qset: torch.Tensor  # int32[L] index into qsets
    lane_meta: torch.Tensor  # int32[L, 3] (image, first MCU, MCUs)
    tables: torch.Tensor     # int32[B, 2, 34] dc/ac: maxcode[17] | valoffset[17]
    huffval: torch.Tensor    # uint8[B, 2, 256] dc/ac symbol lists
    qsets: torch.Tensor      # int32[nq, B, 64] zigzag-order quantizers
    blk_tables: Tuple[Tuple[int, CanonTable, CanonTable], ...]  # (ci, dc, ac) per block
    n_mcus: int              # most MCUs of any lane
    n_images: int
    img_qset: Tuple[int, ...]
    bit0: Optional[torch.Tensor] = None     # int32[L] start bit in the lane's row
    dc0: Optional[torch.Tensor] = None      # int32[L, 4] DC predictors by frame component
    norst_every: int = 0                    # MCUs per norst lane (the last may be short)
    lane_seg: Optional[np.ndarray] = None   # int64[L] marker segment of each lane
    seg_first: Optional[np.ndarray] = None  # int64[segments] first lane of each
    geom: Optional[torch.Tensor] = None     # int32[N, GEOM_WORDS] per-image geometry (several frame sizes)
    parts: Optional[Tuple["PlanPart", ...]] = None  # the geometry buckets of a combine_plans plan

    @property
    def n_lanes(self) -> int:
        return int(self.lane_m.shape[0])

    @property
    def n_words(self) -> int:
        return int(self.bits.shape[1])

    @property
    def blocks_per_mcu(self) -> int:
        return len(self.blk_tables)

    def _map(self, fn) -> "LanePlan":
        return dataclasses.replace(
            self,
            **{
                f.name: fn(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    def to(self, device, non_blocking: bool = False) -> "LanePlan":
        """The plan's tensors on `device`. With `non_blocking`, copies from
        pinned host memory return before they land: the caller keeps this
        plan alive until the stream has passed them."""
        with spans.span(spans.COPY_IN):
            return self._map(lambda t: t.to(device, non_blocking=non_blocking))


def _table_tensors(blk_tables) -> Tuple[torch.Tensor, torch.Tensor]:
    tables = torch.tensor(
        [
            [list(t.maxcode) + list(t.valoffset) for t in (dct, act)]
            for _ci, dct, act in blk_tables
        ],
        dtype=torch.int32,
    )
    huffval = torch.tensor(
        [[list(dct.huffval), list(act.huffval)] for _ci, dct, act in blk_tables],
        dtype=torch.uint8,
    )
    return tables, huffval


def _segment_mcus(frame, scan) -> int:
    if scan.interleaved:
        return frame.mcus_x * frame.mcus_y
    c0 = frame.components[scan.comp_indices[0]]
    return c0.width_blocks * c0.height_blocks


def _image_tables(jpeg, table) -> Tuple:
    """One image's scan and its per-block (component, dc table, ac table)
    list, with `table` mapping a table spec; raises where the planner
    refuses the image's scan structure."""
    frame = jpeg.frame
    if len(jpeg.scans) != 1:
        raise JpegUnsupportedError("one scan only: multi-scan files take decode_multiscan_to_device")
    scan = jpeg.scans[0]
    if not scan.interleaved and frame.n_components != 1:
        raise JpegUnsupportedError(
            "non-interleaved multi-component scan in a one-scan file"
        )
    tables: List[Tuple] = []
    pairs = (
        list(zip(scan.comp_indices, scan.dc_ids, scan.ac_ids))
        if scan.interleaved
        else [(scan.comp_indices[0], scan.dc_ids[0], scan.ac_ids[0])]
    )
    for ci, dc_id, ac_id in pairs:
        c = frame.components[ci]
        dk, ak = (0, dc_id), (1, ac_id)
        if dk not in scan.huff or ak not in scan.huff:
            raise JpegSyntaxError("missing Huffman table")
        n_blk = c.h * c.v if scan.interleaved else 1
        tables += [(ci, table(scan.huff[dk]), table(scan.huff[ak]))] * n_blk
    return scan, tuple(tables)


def _image_segments(frame, scan) -> Tuple[int, int, int, np.ndarray]:
    """(MCUs, restart interval in MCUs, segments, stuffed bytes per
    segment) of a one-scan image; raises where restart segments are
    missing."""
    total_mcus = _segment_mcus(frame, scan)
    ri = scan.restart_interval or total_mcus
    n_seg = -(-total_mcus // ri)
    if len(scan.rst_offsets) + 1 < n_seg:
        raise JpegTruncatedError("missing restart segments")
    if scan.destuffed is not None and scan.dseg_starts is not None and len(
        scan.dseg_starts
    ) >= n_seg + 1:
        ds = scan.dseg_starts
        stuffed = ds[1 : n_seg + 1] - ds[:n_seg]
    else:
        # Stuffed lengths bound the destuffed row size.
        ro = np.asarray(scan.rst_offsets[: n_seg - 1], dtype=np.int64)
        stuffed = np.concatenate([ro, [len(scan.data)]]) - np.concatenate([[0], ro + 2])
    return total_mcus, ri, n_seg, stuffed


def _spec_key(spec) -> bytes:
    return spec.counts.tobytes() + spec.values.tobytes()


def plan_key(jpeg) -> Tuple:
    """The key under which a parsed baseline JPEG shares a lane plan with
    others of its geometry: its per-block Huffman tables. Raises
    JpegError where the planner refuses the image even alone
    (progressive, several scans, a non-interleaved multi-component scan,
    a missing table or restart segments, a segment over MAX_WORDS
    words): such an image needs the per-image rungs."""
    if jpeg.frame.progressive:
        raise JpegUnsupportedError("progressive frames take their own planner")
    scan, tables = _image_tables(jpeg, _spec_key)
    *_counts, stuffed = _image_segments(jpeg.frame, scan)
    if int(stuffed.max()) // 4 + 2 > MAX_WORDS:
        raise JpegUnsupportedError(f"segment too long ({int(stuffed.max()) // 4 + 2} words)")
    return tables


@spans.spanned(spans.PLAN)
def build_block_plan(jpegs: Sequence, pin_memory: bool = False) -> LanePlan:
    """Flat lane plan for a uniform batch of parsed baseline JPEGs.

    Raises JpegUnsupportedError on exactly the batches the reference's
    planner rejects, in the reference's order: progressive, mixed
    geometry, more than one scan, a non-interleaved multi-component
    scan, mixed Huffman tables and a segment over MAX_WORDS words. More
    than MAX_QSETS quantizer sets is the fused entry's limit
    (``decode_batch_to_rgb``), as in the reference; the coefficient
    kernel takes no quantizers. With `pin_memory` the plan's tensors are
    in page-locked host memory (the rows packed straight into it), so
    that a non-blocking copy to the card is asynchronous."""
    if not jpegs:
        raise JpegUnsupportedError("empty batch")
    f0 = jpegs[0].frame
    key0 = (f0.height, f0.width, tuple((c.h, c.v) for c in f0.components))

    seg_rows: List[Tuple[object, int]] = []
    lane_meta: List[np.ndarray] = []
    blk_tables: Optional[Tuple] = None
    canon: Dict[bytes, CanonTable] = {}
    max_words = 0
    max_mcus = 0
    qset_index: Dict[Tuple, int] = {}
    qset_values: List[np.ndarray] = []
    img_qset: List[int] = []

    def table(spec) -> CanonTable:
        key = _spec_key(spec)
        if key not in canon:
            canon[key] = CanonTable.from_spec(spec)
        return canon[key]

    for img_i, jpeg in enumerate(jpegs):
        frame = jpeg.frame
        if frame.progressive:
            raise JpegUnsupportedError(
                "baseline only: progressive frames take wavefront_prog.decode_all_scans_to_rgb_batch"
            )
        key = (frame.height, frame.width, tuple((c.h, c.v) for c in frame.components))
        if key != key0:
            raise JpegUnsupportedError("mixed geometry in one batch: plan_launches buckets images by geometry")
        scan, tables_t = _image_tables(jpeg, table)
        if blk_tables is None:
            blk_tables = tables_t
        elif blk_tables != tables_t:
            raise JpegUnsupportedError(
                "mixed Huffman tables in one batch: decode the images in separate batches"
            )

        qkey = tuple(jpeg.qtables[frame.components[ci].tq].tobytes() for ci, _d, _a in tables_t)
        idx = qset_index.get(qkey)
        if idx is None:
            idx = len(qset_index)
            qset_index[qkey] = idx
            qset_values.append(
                np.stack([jpeg.qtables[frame.components[ci].tq] for ci, _d, _a in tables_t])
            )
        img_qset.append(idx)

        total_mcus, ri, n_seg, stuffed = _image_segments(frame, scan)
        seg_rows.append((scan, n_seg))
        fm = np.arange(n_seg, dtype=np.int64) * ri
        nm = np.minimum(ri, total_mcus - fm).astype(np.int32)
        lane_meta.append(
            np.stack([np.full(n_seg, img_i, np.int32), fm.astype(np.int32), nm], axis=1)
        )
        max_words = max(max_words, int(stuffed.max()) // 4 + 2)
        max_mcus = max(max_mcus, int(nm.max()))

    if max_words > MAX_WORDS:
        raise JpegUnsupportedError(f"segment too long ({max_words} words)")
    # The reference's row width: the longest stuffed segment, in 32-word steps.
    W = -(-max_words // 32) * 32
    meta = np.concatenate(lane_meta, axis=0)
    L = len(meta)

    bits_t = torch.empty((L, W), dtype=torch.int32, pin_memory=pin_memory)
    bits = bits_t.numpy()
    seg_bits = np.zeros(L, dtype=np.int32)
    lane0 = 0
    for scan, n_seg in seg_rows:
        rows, nb = bits[lane0 : lane0 + n_seg], seg_bits[lane0 : lane0 + n_seg]
        if scan.destuffed is not None and scan.dseg_starts is not None and len(
            scan.dseg_starts
        ) >= n_seg + 1:
            native_entropy.rows_from_dest(
                scan.destuffed, scan.dseg_starts, 0, n_seg, W, rows, nb
            )
        else:
            native_entropy.destuff_rows(scan, n_seg, W, rows, nb)
        lane0 += n_seg

    tables_t, huffval_t = _table_tensors(blk_tables)
    plan = LanePlan(
        bits=bits_t,
        seg_bits=torch.from_numpy(seg_bits),
        lane_m=torch.from_numpy(np.ascontiguousarray(meta[:, 2])),
        lane_qset=torch.from_numpy(np.asarray(img_qset, np.int32)[meta[:, 0]]),
        lane_meta=torch.from_numpy(meta),
        tables=tables_t,
        huffval=huffval_t,
        qsets=torch.from_numpy(np.stack(qset_values).astype(np.int32)),
        blk_tables=blk_tables,
        n_mcus=max_mcus,
        n_images=len(jpegs),
        img_qset=tuple(img_qset),
    )
    if pin_memory:
        # The small tensors are copied in; the rows already are pinned.
        plan = plan._map(lambda t: t if t.is_pinned() else t.pin_memory())
    return plan


GEOM_WORDS = build.GEOM_WORDS   # int32 per image of a combined plan's geometry table
MAX_GEOM = build.MAX_GEOM       # images of a plan over several geometries


def launch_key(plan: LanePlan, layout: PlaneLayout) -> Tuple:
    """What kernel A takes by value or stages per CTA, but for the frame
    size: the block layout (each block's component, plane and place in the
    MCU, each plane's sampling), the planes' order and the per-block
    Huffman tables. Restart plans whose keys are equal can share one launch
    (``combine_plans``); their quantizer sets merge, up to MAX_QSETS."""
    return layout.blk, tuple(c[:2] for c in layout.comp), layout.out_order, plan.blk_tables


@dataclasses.dataclass(frozen=True)
class PlanPart:
    """One geometry bucket of a plan: its block layout, its images [first,
    first + n) of the plan, and per scan component the byte offset of its
    [n, plane_h, plane_w] planes in the plan's flat output of that
    component. A plan of one geometry is one part at offset 0."""

    layout: PlaneLayout
    first: int
    n: int
    offsets: Tuple[int, ...]

    @classmethod
    def whole(cls, layout: PlaneLayout, n: int) -> "PlanPart":
        return cls(layout, 0, n, (0,) * len(layout.comp))

    def end(self, sp: int) -> int:
        _h, _v, ph, pw = self.layout.comp[sp]
        return self.offsets[sp] + self.n * ph * pw

    def views(self, flat: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This bucket's planes in the flat outputs, frame component order."""
        out = []
        for sp in self.layout.out_order:
            _h, _v, ph, pw = self.layout.comp[sp]
            out.append(flat[sp][self.offsets[sp]:self.end(sp)].view(self.n, ph, pw))
        return out


def merge_for_launch(plans: Sequence[LanePlan]) -> Optional[Tuple[List[np.ndarray], List[np.ndarray]]]:
    """Whether restart plans of one ``launch_key`` fit one launch of kernel
    A: their quantizer sets merged (the distinct sets in order of first
    appearance, and per plan the map from its set index to the merged one),
    or None where the merge passes MAX_QSETS or several plans pass MAX_GEOM
    images."""
    qindex: Dict[bytes, int] = {}
    qvals: List[np.ndarray] = []
    remap = []
    for p in plans:
        m = []
        for qs in p.qsets.numpy():
            idx = qindex.setdefault(qs.tobytes(), len(qvals))
            if idx == len(qvals):
                qvals.append(qs)
            m.append(idx)
        remap.append(np.asarray(m, np.int32))
    if len(qvals) > MAX_QSETS or (len(plans) > 1 and sum(p.n_images for p in plans) > MAX_GEOM):
        return None
    return qvals, remap


def combine_plans(plans: Sequence[LanePlan], layouts: Sequence[PlaneLayout],
                  pin_memory: bool = False) -> LanePlan:
    """One restart plan over the lanes of `plans` (``build_block_plan``'s,
    geometry buckets whose ``launch_key`` is equal; `layouts` their block
    layouts), so that kernel A decodes them in one launch: the lanes in
    order, rows padded with 0xFF words to the widest plan's row (what
    ``build_block_plan`` gives a row of that width), each lane's image and
    quantizer set renumbered over the whole, the quantizer sets merged
    (``merge_for_launch``) and a part per plan (``parts``). With more than
    one plan it adds, per image, a row of the geometry table ``geom`` (int32
    [N, GEOM_WORDS]: MCU width, 3 zeros, then per scan component the plane's
    height, width and byte offset / 64 in that component's flat output),
    which selects kernel A's mixed form. With `pin_memory` every tensor is
    page-locked. Raises ValueError on plans that cannot share a launch."""
    key = launch_key(plans[0], layouts[0])
    if (len(plans) != len(layouts) or any(launch_key(p, lay) != key for p, lay in zip(plans, layouts))
            or any(p.bit0 is not None for p in plans)):
        raise ValueError("combine_plans: restart plans of one launch key only")
    merged = merge_for_launch(plans)
    if merged is None:
        raise ValueError(f"combine_plans: over {MAX_QSETS} quantizer sets or {MAX_GEOM} images")
    qvals, remap = merged
    p0 = plans[0]
    L = sum(p.n_lanes for p in plans)
    W = max(p.n_words for p in plans)
    N = sum(p.n_images for p in plans)

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, pin_memory=pin_memory)

    out = dict(bits=empty(L, W), seg_bits=empty(L), lane_m=empty(L), lane_qset=empty(L), lane_meta=empty(L, 3),
               tables=empty(*p0.tables.shape), huffval=empty(*p0.huffval.shape, dtype=torch.uint8),
               qsets=empty(len(qvals), *p0.qsets.shape[1:]), geom=empty(N, GEOM_WORDS))
    bits, seg_bits, lane_m, lane_qset, lane_meta, geom = (
        out[k].numpy() for k in ("bits", "seg_bits", "lane_m", "lane_qset", "lane_meta", "geom"))
    out["tables"].copy_(p0.tables)
    out["huffval"].copy_(p0.huffval)
    out["qsets"].numpy()[...] = np.stack(qvals)
    geom[...] = 0
    off = [0] * len(layouts[0].comp)
    parts, img_qset = [], []
    l0 = i0 = 0
    for p, lay, m in zip(plans, layouts, remap):
        l1, w = l0 + p.n_lanes, p.n_words
        bits[l0:l1, :w] = p.bits.numpy()
        bits[l0:l1, w:] = -1
        seg_bits[l0:l1] = p.seg_bits.numpy()
        lane_m[l0:l1] = p.lane_m.numpy()
        lane_qset[l0:l1] = m[p.lane_qset.numpy()]
        lane_meta[l0:l1] = p.lane_meta.numpy()
        lane_meta[l0:l1, 0] += i0
        img_qset += [int(m[q]) for q in p.img_qset]
        parts.append(PlanPart(lay, i0, p.n_images, tuple(off)))
        rows = geom[i0:i0 + p.n_images]
        rows[:, 0] = lay.mcus_x
        for sp, (_h, _v, ph, pw) in enumerate(lay.comp):
            rows[:, 4 + 3 * sp] = ph
            rows[:, 5 + 3 * sp] = pw
            rows[:, 6 + 3 * sp] = (off[sp] + np.arange(p.n_images, dtype=np.int64) * ph * pw) // 64
            off[sp] += p.n_images * ph * pw
        l0, i0 = l1, i0 + p.n_images
    if max(off) // 64 >= 2**31:
        raise ValueError("combine_plans: outputs over the geometry table's offsets")
    if len(plans) == 1:
        del out["geom"]   # one geometry: kernel A's one-geometry form, which reads no table
    return LanePlan(**out, blk_tables=p0.blk_tables, n_mcus=max(p.n_mcus for p in plans), n_images=N,
                    img_qset=tuple(img_qset), parts=tuple(parts))


def bucket_key(jpeg) -> Tuple:
    """The geometry bucket of a parsed baseline JPEG: frame size, sampling
    and color space. Color interpretation is marker-driven (JFIF/Adobe
    APP14): a YCbCr and an Adobe-RGB file of one geometry must not share a
    transform."""
    frame = jpeg.frame
    return (frame.height, frame.width, tuple((c.h, c.v) for c in frame.components),
            bitstream.color_space(jpeg))


@dataclasses.dataclass
class LaunchGroup:
    """Geometry buckets that share one kernel-A launch: per bucket, its
    images' positions in the planner's input and the images; and the plan
    over them, a part per bucket in that order."""

    at: List[List[int]]
    jpegs: List[List]
    plan: LanePlan

    @property
    def positions(self) -> List[int]:
        """The planner-input position of each image of the plan, in order."""
        return [k for at in self.at for k in at]


def plan_launches(jpegs: Sequence, pin_memory: bool = False) -> Tuple[List[LaunchGroup], List[List[int]]]:
    """The kernel-A launches of parsed baseline JPEGs: the images bucket by
    ``bucket_key`` in order of first appearance, each bucket takes one
    ``build_block_plan`` (one ``plan`` span), and a bucket joins the newest
    launch group of its ``launch_key`` and color space while the group still
    fits one launch (``merge_for_launch``), else it opens a new group.
    Returns (launch groups, refused buckets): a bucket whose plan raises
    JpegError or passes MAX_QSETS quantizer sets comes back as its
    positions in `jpegs`. With `pin_memory` each group's plan is
    page-locked: the one bucket of a uniform input packs its rows straight
    into pinned memory; otherwise each group's plan is ``combine_plans`` of
    its buckets', into pinned memory. Unpinned, a group of one bucket keeps
    its bucket's plan."""
    by_key: Dict[Tuple, List[int]] = {}
    for k, j in enumerate(jpegs):
        by_key.setdefault(bucket_key(j), []).append(k)
    alone = len(by_key) == 1
    planned, refused = [], []
    for at in by_key.values():
        js = [jpegs[k] for k in at]
        try:
            plan = build_block_plan(js, pin_memory=pin_memory and alone)
        except JpegError:
            refused.append(at)
            continue
        if int(plan.qsets.shape[0]) > MAX_QSETS:
            refused.append(at)
            continue
        planned.append((at, js, plan, PlaneLayout.of(ImageGeom.of(js[0]))))
    members: List[List[int]] = []
    newest: Dict[Tuple, int] = {}
    for i, (_at, js, plan, layout) in enumerate(planned):
        key = (launch_key(plan, layout), bitstream.color_space(js[0]))
        g = newest.get(key)
        if g is not None and merge_for_launch([planned[j][2] for j in members[g] + [i]]) is not None:
            members[g].append(i)
            continue
        newest[key] = len(members)
        members.append([i])
    groups = []
    for idx in members:
        ats, js, plans, layouts = zip(*(planned[i] for i in idx))
        keep = len(plans) == 1 and (alone or not pin_memory)
        groups.append(LaunchGroup(list(ats), list(js), plans[0] if keep else
                                  combine_plans(plans, layouts, pin_memory=pin_memory)))
    return groups, refused


def plan_from_reference(ref_plan) -> LanePlan:
    """The reference's BlockPlan (numpy, [G, 8, K, ...] lane groups) as
    the port's flat plan: lane groups flattened and trimmed to the real
    lane count, tables and quantizer sets as tensors, and for a norst
    plan the start bits and the [G, 4, 8, K] DC priming as [L, 4]. Lets a
    test feed the identical plan to both decoders."""
    L = ref_plan.n_lanes

    def flat(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).reshape(-1)[:L]).astype(np.int32))

    norst = {}
    if ref_plan.bit0 is not None:
        dc0 = np.asarray(ref_plan.lane_dc0).transpose(0, 2, 3, 1).reshape(-1, 4)[:L]
        norst = dict(
            bit0=flat(ref_plan.bit0),
            dc0=torch.from_numpy(np.ascontiguousarray(dc0).astype(np.int32)),
            norst_every=ref_plan.norst_every,
            lane_seg=np.asarray(ref_plan.lane_seg, np.int64),
            seg_first=np.asarray(ref_plan.seg_first, np.int64),
        )

    blk_tables = tuple(
        (ci, CanonTable(tuple(d.maxcode), tuple(d.valoffset), tuple(d.huffval)),
         CanonTable(tuple(a.maxcode), tuple(a.valoffset), tuple(a.huffval)))
        for ci, d, a in ref_plan.blk_tables
    )
    tables, huffval = _table_tensors(blk_tables)
    W = ref_plan.n_words
    return LanePlan(
        bits=torch.from_numpy(
            np.ascontiguousarray(np.asarray(ref_plan.bits).reshape(-1, W)[:L])
        ),
        seg_bits=flat(ref_plan.seg_bits),
        lane_m=flat(ref_plan.lane_m),
        lane_qset=flat(ref_plan.lane_qset),
        lane_meta=torch.from_numpy(np.asarray(ref_plan.lane_meta, np.int32)),
        tables=tables,
        huffval=huffval,
        qsets=torch.tensor(ref_plan.qsets, dtype=torch.int32),
        blk_tables=blk_tables,
        n_mcus=ref_plan.n_mcus,
        n_images=ref_plan.images,
        img_qset=tuple(ref_plan.img_qset),
        **norst,
    )


# ---------------------------------------------------------------------------
# Skeleton split: lanes that start mid-stream (marker-free scans and
# restart intervals over the row cap)
# ---------------------------------------------------------------------------


def _skeleton_walk_py(dest: bytes, jpeg, scan, total: int, every: int):
    """The skeleton walk's plain version (pure python over one destuffed
    segment): (int64 bit offsets of every `every`-th MCU plus the total,
    int32 [offsets, scan components] DC predictors at each). The native
    ``scan_split_buf`` is held to it. Raises JpegHuffmanError on a bad DC
    size or an AC run past the block, JpegTruncatedError on an overrun."""
    from .. import huffman as hf

    tbls = hf.build_tables(scan.huff)
    frame = jpeg.frame
    if scan.interleaved:
        sps: List[int] = []
        for p, ci in enumerate(scan.comp_indices):
            c = frame.components[ci]
            sps += [p] * (c.h * c.v)
    else:
        sps = [0]
    dcts = [tbls[(0, scan.dc_ids[p])] for p in range(scan.n_comps)]
    acts = [tbls[(1, scan.ac_ids[p])] for p in range(scan.n_comps)]
    r = hf.BitReader(bytes(dest))
    offs, dcs = [], []
    pred = [0] * scan.n_comps
    for m in range(total):
        if m % every == 0:
            offs.append(r.pos * 8 + r.pad_bits - r.cnt)
            dcs.append(list(pred))
        for sp in sps:
            t = hf.decode_symbol(r, dcts[sp])
            if t > 15:
                raise JpegHuffmanError("bad DC size")
            pred[sp] += hf.extend(r.receive(t), t)
            k = 1
            while k < 64:
                rs = hf.decode_symbol(r, acts[sp])
                run, size = rs >> 4, rs & 15
                if size == 0:
                    if run == 15:
                        k += 16
                        continue
                    break
                k += run
                if k > 63:
                    raise JpegHuffmanError("AC run past end of block")
                r.receive(size)
                k += 1
    offs.append(r.pos * 8 + r.pad_bits - r.cnt)
    dcs.append(list(pred))
    if r.overrun():
        raise JpegTruncatedError("entropy stream truncated")
    return (np.asarray(offs, np.int64),
            np.asarray(dcs, np.int32).reshape(len(offs), scan.n_comps))


def _scan_split_host(jpeg, scan, every: int):
    """Skeleton scan of every restart segment (or of the one marker-free
    stream) on the host, by the native walk. Returns (destuffed uint8
    buffer, int64 absolute bit offsets [L + 1], int64 first lane of each
    marker segment, int32 [L, scan components] DC predictors at each
    lane's first MCU, reset to 0 at each marker as T.81 resets them). Lanes start every `every` MCUs
    inside a marker segment and at every marker (`every` divides the
    restart interval)."""
    total = _segment_mcus(jpeg.frame, scan)
    ri = scan.restart_interval or total
    dest, seg_starts = native_entropy.destuff_segments(scan)
    offs_all, dcs_all, seg_first = [], [], []
    lane0 = mcu = si = 0
    last_end = 0
    while mcu < total:
        n_m = min(ri, total - mcu)
        s0, s1 = int(seg_starts[si]), int(seg_starts[si + 1])
        sub = dest[s0:s1]
        offs, dcs = native_entropy.scan_split_buf(sub, jpeg, scan, n_m, every)
        seg_first.append(lane0)
        lane0 += len(offs) - 1
        offs_all.append(offs[:-1] + s0 * 8)
        dcs_all.append(dcs[:-1])
        last_end = offs[-1] + s0 * 8
        mcu += n_m
        si += 1
    offs_flat = np.concatenate(offs_all + [[last_end]]).astype(np.int64)
    return dest, offs_flat, np.asarray(seg_first, np.int64), np.concatenate(dcs_all)


CARD_ROW_WORDS = 4   # a card plan's row step, 16 bytes; the reference's 32 words are the TPU's tile


def _snap_divisor(e: int, ri: int) -> int:
    """The largest divisor of the restart interval `ri` that is at most
    `e` (and at least 1)."""
    e = max(1, min(e, ri))
    while ri % e:
        e -= 1
    return e


def card_every(total_mcus: int, wave_lanes: int, ri: int, default: int) -> int:
    """MCUs per norst lane on a card: as many lanes as one wave of kernel A
    holds (`wave_lanes`), to the nearest whole MCU count, snapped to a
    divisor of the restart interval `ri` and never above `default`, the
    reference's split of the scan. A lane's serial chain, not the card's
    bandwidth, bounds kernel A on a marker-free scan, so the wave is what
    sets the lane count."""
    return _snap_divisor(min(max(1, round(total_mcus / max(1, wave_lanes))), default), ri)


def card_wave_lanes(device, blk_tables) -> int:
    """Lanes in one wave of kernel A on CUDA `device` for a one-image plan
    with these per-block tables: SMs x resident CTAs per SM at the shared
    memory the launch asks for x threads per CTA."""
    device = torch.device(device)
    ctas = build.wavefront_occupancy(device, True, len(blk_tables), 1,
                                     len({ci for ci, _d, _a in blk_tables}),
                                     max(table_sets(blk_tables)) + 1)
    return torch.cuda.get_device_properties(device).multi_processor_count * ctas * build.WF_THREADS


@spans.spanned(spans.PLAN)
def build_norst_plan(jpeg, every: int = 0, wave: Optional[Callable[[Tuple], int]] = None) -> LanePlan:
    """Lane plan of one parsed baseline scan cut at skeleton-scan bit
    offsets: for marker-free streams (the whole scan one serial chain)
    and for restart intervals whose segments exceed the row cap. `every`
    (0: the reference's default, about half of MAX_WORDS per lane) snaps
    to a divisor of the restart interval, so every lane holds `every`
    MCUs but the last; it halves while a lane's row would exceed
    MAX_WORDS. Each lane starts at bit ``bit0`` of its row (the words
    from the one holding its first bit on, 0xFF past the stream's end)
    with its DC predictors primed from the skeleton scan (``dc0``, reset
    at markers), so kernels A and 2 decode true DCs with no fixup pass.
    Rows are as wide as the longest lane needs, in 32-word steps as the
    reference's. `wave` makes a plan for a card (``card_norst_plan``): given
    the per-block tables, it returns the lanes one wave of kernel A holds
    there. Its rows go in 4-word steps (the fields stay the reference's
    plan's at the same `every`, each row its first words); `every` 0 takes
    ``card_every``'s split, and the plan counts its lanes and that wave
    (``norst_lanes``, ``norst_wave``) in the traced unit.
    Raises as the reference's planner: JpegUnsupportedError outside its
    scope, JpegHuffmanError or JpegTruncatedError from the walk."""
    frame = jpeg.frame
    if frame.progressive:
        raise JpegUnsupportedError("norst plan: baseline only")
    if len(jpeg.scans) != 1:
        raise JpegUnsupportedError("norst plan: one scan only")
    scan = jpeg.scans[0]
    if not scan.interleaved and frame.n_components != 1:
        raise JpegUnsupportedError("norst plan: non-interleaved multi-component scan")
    total_mcus = _segment_mcus(frame, scan)
    if total_mcus <= 0:
        raise JpegUnsupportedError("empty scan")
    ri = scan.restart_interval or total_mcus
    blk_tables = wave_lanes = None
    if every <= 0:
        avg_bits = max(1, len(scan.data) * 8 // total_mcus)
        every = _snap_divisor(max(1, (MAX_WORDS * 32 // 2) // avg_bits), ri)
        if wave is not None:
            _scan, blk_tables = _image_tables(jpeg, CanonTable.from_spec)
            wave_lanes = wave(blk_tables)
            every = card_every(total_mcus, wave_lanes, ri, every)
    every = _snap_divisor(every, ri)
    row_step = 32 if wave is None else CARD_ROW_WORDS
    W = MAX_WORDS + 1
    for _ in range(6):
        dest, offs, seg_first, dcs = _scan_split_host(jpeg, scan, every)
        start_words = offs[:-1] >> 5
        end_rel = offs[1:] - (start_words << 5)
        W = -(-int(end_rel.max()) // 32) + 1
        W = min(-(-W // row_step) * row_step, MAX_WORDS + 32)
        if W <= MAX_WORDS or every == 1:
            break
        every = _snap_divisor(every // 2, ri)
    if W > MAX_WORDS:
        raise JpegUnsupportedError("skeleton split: a lane exceeds the row cap")

    L = len(offs) - 1
    # Row l is words[start_words[l]:][:W], the stream read as big-endian
    # words (swapped once), 0xFF past its end: one gather of sliding-window
    # views.
    n_words = -(-len(dest) // 4) + W + 1
    buf = np.full(n_words * 4, 0xFF, np.uint8)
    buf[: len(dest)] = dest
    words = buf.view(">u4").astype(np.uint32).view(np.int32)
    bits = np.lib.stride_tricks.sliding_window_view(words, W)[start_words]
    dc0 = np.zeros((L, 4), np.int32)
    for p, ci in enumerate(scan.comp_indices if scan.interleaved else scan.comp_indices[:1]):
        dc0[:, ci] = dcs[:, p]
    fm = np.arange(L, dtype=np.int64) * every
    nm = np.minimum(every, total_mcus - fm).astype(np.int32)
    meta = np.stack([np.zeros(L, np.int32), fm.astype(np.int32), nm], axis=1)

    if blk_tables is None:
        _scan, blk_tables = _image_tables(jpeg, CanonTable.from_spec)
    if wave_lanes is not None:
        spans.count(spans.NORST_LANES, L)
        spans.count(spans.NORST_WAVE, wave_lanes)
    qset = np.stack([jpeg.qtables[frame.components[ci].tq] for ci, _d, _a in blk_tables])
    tables_t, huffval_t = _table_tensors(blk_tables)
    return LanePlan(
        bits=torch.from_numpy(bits),
        seg_bits=torch.from_numpy(end_rel.astype(np.int32)),
        lane_m=torch.from_numpy(nm),
        lane_qset=torch.from_numpy(np.zeros(L, np.int32)),
        lane_meta=torch.from_numpy(meta),
        tables=tables_t,
        huffval=huffval_t,
        qsets=torch.from_numpy(qset[None].astype(np.int32)),
        blk_tables=blk_tables,
        n_mcus=int(nm.max()),
        n_images=1,
        img_qset=(0,),
        bit0=torch.from_numpy((offs[:-1] - (start_words << 5)).astype(np.int32)),
        dc0=torch.from_numpy(dc0),
        norst_every=every,
        lane_seg=fm // ri,
        seg_first=seg_first,
    )


def card_norst_plan(jpeg, device) -> LanePlan:
    """``build_norst_plan`` with the split and rows of CUDA `device`: one
    wave of kernel A's lanes (``card_every``), rows in 4-word steps."""
    return build_norst_plan(jpeg, wave=functools.partial(card_wave_lanes, device))


# ---------------------------------------------------------------------------
# Plane layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlaneLayout:
    """Where block position b of MCU g lands: plane sp = blk[b][1], block
    row (g // mcus_x) * v + dv, block column (g % mcus_x) * h + dh."""

    mcus_x: int
    blk: Tuple[Tuple[int, int, int, int], ...]    # (ci, sp, dv, dh) per block
    comp: Tuple[Tuple[int, int, int, int], ...]   # (h, v, plane_h, plane_w) per sp
    out_order: Tuple[int, ...]                    # sp of each returned plane

    @classmethod
    def of(cls, geom: ImageGeom) -> "PlaneLayout":
        frame = geom.frame
        if geom.interleaved:
            cis = geom.comp_indices
            hv = [(frame.components[ci].h, frame.components[ci].v) for ci in cis]
            mcus_x = frame.mcus_x
            out_order = tuple(cis.index(c.index) for c in frame.components)
        else:
            cis = geom.comp_indices[:1]
            hv = [(1, 1)]
            mcus_x = frame.components[cis[0]].width_blocks
            out_order = (0,)
        blk, comp = [], []
        for sp, (ci, (h, v)) in enumerate(zip(cis, hv)):
            c = frame.components[ci]
            comp.append((h, v, c.padded_hb * 8, c.padded_wb * 8))
            blk += [(ci, sp, dv, dh) for dv in range(v) for dh in range(h)]
        return cls(mcus_x, tuple(blk), tuple(comp), out_order)

    def alloc(self, n: int, device, emit: str = "pixels") -> List[torch.Tensor]:
        """Zeroed outputs, one per scan component: uint8 [n, plane_h,
        plane_w] planes, or with ``emit="coeff"`` int32 [n, plane_h/8 *
        plane_w/8, 64] coefficient blocks."""
        if emit == "coeff":
            return [torch.zeros((n, ph // 8 * (pw // 8), 64), dtype=torch.int32, device=device)
                    for _h, _v, ph, pw in self.comp]
        return [torch.zeros((n, ph, pw), dtype=torch.uint8, device=device)
                for _h, _v, ph, pw in self.comp]


# ---------------------------------------------------------------------------
# Plain version of kernels A and 2
# ---------------------------------------------------------------------------


def _receive_extend(win: torch.Tensor, length: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """EXTEND of the `size` magnitude bits that follow a `length`-bit code
    in the 32-bit window (int64 tensors holding uint32 values)."""
    after = (win << length) & 0xFFFFFFFF
    mag = torch.where(size > 0, after >> (32 - size), 0)
    neg = (size > 0) & (mag < (1 << (size - 1).clamp(min=0)))
    return torch.where(neg, mag - (1 << size) + 1, mag)


def lane_windows(bits: torch.Tensor):
    """For int32 [L, W] word rows, the function cur -> the 32-bit window
    at bit cur of each lane (int64 tensors). A word w reads the
    reference's load: row[w mod P] inside the row, 0 in the [W, P) gap,
    for P the power of two >= W (reads past the segment's end)."""
    L, W = bits.shape
    P = 1 << max(W - 1, 1).bit_length()
    words = bits.to(torch.int64) & 0xFFFFFFFF

    def load(w):
        i = w & (P - 1)
        v = words.gather(1, i.clamp(max=W - 1)[:, None])[:, 0]
        return torch.where(i < W, v, 0)

    def window(cur):
        w, sh = cur >> 5, cur & 31
        hi, lo = load(w), load(w + 1)
        return ((hi << sh) & 0xFFFFFFFF) | torch.where(sh == 0, 0, lo >> (32 - sh))

    return window


def _decode_symbol(win: torch.Tensor, mc, vo, huffval: torch.Tensor):
    """Canonical decode for every lane: (symbol, code length), length 17
    for an invalid code. The shortest length whose maxcode admits the
    peeked code wins."""
    length = torch.full_like(win, 17)
    idx = torch.zeros_like(win)
    for l in range(16, 0, -1):
        if mc[l] < 0:
            continue
        peek = win >> (32 - l)
        sel = peek <= mc[l]
        length = torch.where(sel, l, length)
        idx = torch.where(sel, peek + vo[l], idx)
    return huffval[idx.clamp(0, 255)], length


LOOKAHEAD_BITS = 9


def lookahead_table(table: CanonTable) -> torch.Tensor:
    """The kernels' 9-bit lookahead for one Huffman table (the rule of
    ``tj_lookahead_entry``, csrc/common.cuh, which kernels A and 2 build
    per CTA; kernels 7-9 take this table from their plan), int32 [512]:
    entry p, for a window whose top nine bits are p, is (length << 8) |
    symbol for the shortest length l <= 9 whose maxcode admits the
    window's l-bit prefix (the symbol index clamped to 0..255, as
    ``_decode_symbol`` clamps it), else 0: the decode then walks the
    maxcodes from length 10."""
    p = torch.arange(1 << LOOKAHEAD_BITS, dtype=torch.int64)
    hv = torch.tensor(table.huffval, dtype=torch.int64)
    out = torch.zeros_like(p)
    for l in range(LOOKAHEAD_BITS, 0, -1):
        if table.maxcode[l] < 0:
            continue
        peek = p >> (LOOKAHEAD_BITS - l)
        sym = hv[(peek + table.valoffset[l]).clamp(0, 255)]
        out = torch.where(peek <= table.maxcode[l], (l << 8) | sym, out)
    return out.to(torch.int32)


def decode_lanes_plain(plan: LanePlan, layout: PlaneLayout, outs: Sequence[torch.Tensor],
                       err: torch.Tensor, emit: str = "pixels") -> None:
    """Kernels A and 2's plain torch version on the plan's device: all
    lanes step together, one MCU round and block position at a time (one
    DC step for all lanes, then an AC loop masked per lane). Then, for
    ``emit="pixels"`` (kernel A), dequant, un-zigzag, islow IDCT, +128
    and clamp, and a scatter of the 8x8 tiles into ``outs[sp]``
    (uint8 [N, plane_h, plane_w]); for ``emit="coeff"`` (kernel 2), the
    zigzag block with its absolute DC into ``outs[sp][img, block row *
    padded_wb + block column]`` (int32 [N, padded_hb*padded_wb, 64]).
    Writes the per-lane error bits into ``err`` (int32[L]). A norst
    plan's lanes start at their ``bit0`` with predictors from ``dc0``. A
    plan over several geometries (``plan.geom``, pixels only) places each
    lane's blocks by its image's row of the table, into the flat
    ``outs[sp]`` (uint8 [bytes])."""
    if emit not in ("pixels", "coeff"):
        raise ValueError(f"emit {emit!r}")
    if plan.geom is not None and emit != "pixels":
        raise ValueError("a plan over several geometries decodes to pixels only")
    dev = plan.bits.device
    L = plan.n_lanes
    window = lane_windows(plan.bits)
    tbl = plan.tables.tolist()
    hv = plan.huffval.to(torch.int64)
    lane_m = plan.lane_m.to(torch.int64)
    img = plan.lane_meta[:, 0].to(torch.int64)
    first = plan.lane_meta[:, 1].to(torch.int64)
    if emit == "pixels":
        qlane = plan.qsets[plan.lane_qset.to(torch.int64)]      # [L, B, 64]
    r8 = torch.arange(8, device=dev)
    geom = plan.geom.to(torch.int64)[img] if plan.geom is not None else None   # [L, GEOM_WORDS]
    mcus_x = geom[:, 0] if geom is not None else layout.mcus_x

    # A norst lane starts at its bit0 with primed predictors; a restart
    # lane at bit 0 with zero predictors.
    if plan.bit0 is None:
        cur = torch.zeros(L, dtype=torch.int64, device=dev)
        pred = torch.zeros(4, L, dtype=torch.int64, device=dev)
    else:
        cur = plan.bit0.to(torch.int64)
        pred = plan.dc0.to(torch.int64).t().contiguous()
    e = torch.zeros(L, dtype=torch.int64, device=dev)
    coef = torch.zeros(L, 64, dtype=torch.int64, device=dev)
    for m in range(plan.n_mcus):
        active = m < lane_m
        g = first + m
        my, mx = g // mcus_x, g % mcus_x
        for b, (ci, sp, dv, dh) in enumerate(layout.blk):
            dmc, dvo = tbl[b][0][:17], tbl[b][0][17:]
            amc, avo = tbl[b][1][:17], tbl[b][1][17:]
            ok = active & (e == 0)
            # DC: one symbol for every lane.
            win = window(cur)
            t, dlen = _decode_symbol(win, dmc, dvo, hv[b, 0])
            bad = ok & ((dlen > 16) | (t > 15))
            t = torch.where(t > 15, 0, t)
            diff = _receive_extend(win, dlen, t)
            pred[ci] = pred[ci] + torch.where(ok, diff, 0)
            cur = cur + torch.where(ok, dlen + t, 0)
            e = torch.where(bad, _ERR_BADCODE, e)
            # AC: until every lane's block ends (EOB, k = 64 or an error).
            coef.zero_()
            k = torch.where(ok, 1, 64)
            busy = ok & (k < 64) & (e == 0)
            while bool(busy.any()):
                win = window(cur)
                rs, alen = _decode_symbol(win, amc, avo, hv[b, 1])
                run, size = rs >> 4, rs & 0x0F
                val = _receive_extend(win, alen, size)
                nk = k + torch.where(size > 0, run, 0)
                emit_ok = busy & (size > 0) & (nk <= 63)
                # Each slot is written at most once per block (k only
                # grows), so adding into the zeroed block sets it.
                coef.scatter_add_(1, nk.clamp(0, 63)[:, None], torch.where(emit_ok, val, 0)[:, None])
                cur = cur + torch.where(busy, alen + size, 0)
                is_eob = (size == 0) & (run != 15)
                is_zrl = (size == 0) & (run == 15)
                k = torch.where(
                    busy, torch.where(is_eob, 64, torch.where(is_zrl, k + 16, nk + 1)), k
                )
                e = torch.where(busy & (alen > 16), _ERR_BADCODE, e)
                e = torch.where(busy & (size > 0) & (nk > 63), _ERR_RUN, e)
                busy = ok & (k < 64) & (e == 0)
            coef[:, 0] = torch.where(ok, pred[ci], 0)
            sel = torch.nonzero(active)[:, 0]
            if not sel.numel():
                continue
            h, v, _ph, pw = layout.comp[sp]
            brow, bcol = my[sel] * v + dv, mx[sel] * h + dh
            if emit == "coeff":
                outs[sp][img[sel], brow * (pw // 8) + bcol] = coef[sel].to(torch.int32)
                continue
            # Epilogue: int32 arithmetic that wraps, as the reference's.
            deq = T.dequantize(coef[sel].to(torch.int32), qlane[sel, b])
            tile = T.idct8x8_islow(deq)
            rows = (brow * 8)[:, None, None] + r8[None, :, None]
            cols = (bcol * 8)[:, None, None] + r8[None, None, :]
            if geom is None:
                outs[sp][img[sel][:, None, None], rows, cols] = tile
            else:
                at = geom[sel, 6 + 3 * sp] * 64
                outs[sp][at[:, None, None] + rows * geom[sel, 5 + 3 * sp][:, None, None] + cols] = tile
    trunc = (cur > plan.seg_bits.to(torch.int64) + 7) & (lane_m > 0)
    err.copy_((e | torch.where(trunc, _ERR_TRUNC, 0)).to(torch.int32))


# ---------------------------------------------------------------------------
# Kernel A and kernel 2 wrappers
# ---------------------------------------------------------------------------


def table_sets(blk_tables) -> Tuple[int, ...]:
    """The staged table set of each block position: the kernels stage one
    copy of each distinct (dc, ac) table pair, and blocks whose pairs are
    equal (the blocks of one component) share it."""
    seen: Dict[Tuple[CanonTable, CanonTable], int] = {}
    return tuple(seen.setdefault((dct, act), len(seen)) for _ci, dct, act in blk_tables)


def _launch_wavefront(plan: LanePlan, layout: PlaneLayout, outs: Sequence[torch.Tensor],
                      err: torch.Tensor, emit: str = "pixels") -> None:
    """Launch kernel A (emit "pixels") or 2 ("coeff"). The layout and the
    table sets go by value in the kernel's arguments and the quantizers
    stay in the plan's zigzag order, so nothing is copied to the card and
    the launch never waits for the stream. A plan over several geometries
    (``plan.geom``) launches kernel A's mixed form into flat outputs
    (uint8 [bytes], one per scan component; `layout` gives the block
    layout and sampling), counted as "wavefront_pixels_mixed"."""
    dev = plan.bits.device
    B = plan.blocks_per_mcu
    nq = int(plan.qsets.shape[0])
    mixed = plan.geom is not None
    name = "wavefront_" + emit
    if mixed and (emit != "pixels" or tuple(plan.geom.shape) != (plan.n_images, GEOM_WORDS)
                  or not 0 < plan.n_images <= MAX_GEOM):
        raise ValueError(f"{name}: a geometry table of [{plan.n_images}, {GEOM_WORDS}] with pixels, "
                         f"at most {MAX_GEOM} images")
    ptrs = [o.data_ptr() for o in outs] + [0] * (4 - len(outs))
    out_spec = (torch.uint8, 1 if mixed else 3) if emit == "pixels" else (torch.int32, 3)
    L, W = plan.bits.shape
    if (plan.bit0 is None) != (plan.dc0 is None) or (plan.bit0 is not None and (
            tuple(plan.bit0.shape) != (L,) or tuple(plan.dc0.shape) != (L, 4))):
        raise ValueError(f"{name}: bit0 and dc0 must be both None, or [{L}] and [{L}, 4]")
    norst = [] if plan.bit0 is None else [(plan.bit0, torch.int32, 1), (plan.dc0, torch.int32, 2)]
    build.check_args(
        name, dev,
        [(plan.bits, torch.int32, 2), (plan.seg_bits, torch.int32, 1),
         (plan.lane_m, torch.int32, 1), (plan.lane_qset, torch.int32, 1),
         (plan.lane_meta, torch.int32, 2), (plan.tables, torch.int32, 3),
         (plan.huffval, torch.uint8, 3), (plan.qsets, torch.int32, 3), (err, torch.int32, 1)]
        + norst + [(o, *out_spec) for o in outs] + ([(plan.geom, torch.int32, 2)] if mixed else []),
    )
    sets = table_sets(plan.blk_tables)
    if (B > 10 or len(layout.blk) != B or len(outs) > 4 or max(sets) >= 4
            or (emit == "pixels" and nq > MAX_QSETS)):
        raise ValueError(f"{name}: B={B}, nq={nq}, outputs={len(outs)}, "
                         f"table sets={max(sets) + 1} out of range")
    if emit == "coeff":
        build.check_aligned(name, outs)  # the warp stores each block as 16 int4 words
    if plan.dc0 is not None:
        build.check_aligned(name, [plan.dc0])  # a lane's four are one int4
    blk = np.ascontiguousarray(layout.blk, dtype=np.int32)
    comp = np.ascontiguousarray(layout.comp, dtype=np.int32)
    lut_of = np.asarray(sets, dtype=np.int32)
    P = 1 << max(W - 1, 1).bit_length()
    # Null start state: every lane at bit 0 with zero predictors.
    bit0 = plan.bit0.data_ptr() if plan.bit0 is not None else None
    dc0 = plan.dc0.data_ptr() if plan.dc0 is not None else None
    if emit == "pixels":
        rc = build.call(
            dev, "tj_wavefront_pixels", plan.bits.data_ptr(), W, P,
            plan.seg_bits.data_ptr(), plan.lane_m.data_ptr(), plan.lane_qset.data_ptr(),
            plan.lane_meta.data_ptr(), bit0, dc0, L,
            plan.tables.data_ptr(), plan.huffval.data_ptr(), plan.qsets.data_ptr(),
            blk.ctypes.data, comp.ctypes.data, lut_of.ctypes.data, B, nq, len(outs), layout.mcus_x,
            plan.geom.data_ptr() if mixed else None, plan.n_images if mixed else 0, *ptrs, err.data_ptr(),
        )
    else:
        rc = build.call(
            dev, "tj_wavefront_coeff", plan.bits.data_ptr(), W, P,
            plan.seg_bits.data_ptr(), plan.lane_m.data_ptr(), plan.lane_meta.data_ptr(),
            bit0, dc0, L, plan.tables.data_ptr(), plan.huffval.data_ptr(),
            blk.ctypes.data, comp.ctypes.data, lut_of.ctypes.data, B, len(outs), layout.mcus_x,
            *ptrs, err.data_ptr(),
        )
    build.raise_on_error(rc, name)
    build.launched(name + "_mixed" if mixed else name)


def _decode_lanes(plan: LanePlan, geoms: Optional[Sequence[ImageGeom]], device, plain: bool, emit: str,
                  layout: Optional[PlaneLayout] = None):
    """Kernel A or 2 (or their plain version) over the plan on `device`.
    Pixels: per part (the plan's ``parts``, else one part of the first
    image's layout), its planes: views of one zeroed flat output per scan
    component. Coefficients: per scan component in frame order, the
    zeroed batch ``layout.alloc`` gives."""
    device = torch.device(device)
    plan = plan.to(device)
    if emit == "pixels":
        parts = plan.parts or (PlanPart.whole(PlaneLayout.of(geoms[0]), len(geoms)),)
        layout = parts[0].layout
        flat = [torch.zeros(parts[-1].end(sp), dtype=torch.uint8, device=device) for sp in range(len(layout.comp))]
        # Kernel A's one-geometry form takes [n, plane_h, plane_w] planes.
        outs = flat if plan.geom is not None else [
            f.view(parts[0].n, ph, pw) for f, (_h, _v, ph, pw) in zip(flat, layout.comp)]
    else:
        layout = layout or PlaneLayout.of(geoms[0])
        outs = layout.alloc(len(geoms), device, emit)
    err = torch.zeros(plan.n_lanes, dtype=torch.int32, device=device)
    if plain or device.type == "cpu":
        decode_lanes_plain(plan, layout, outs, err, emit)
    elif device.type == "cuda":
        _launch_wavefront(plan, layout, outs, err, emit)
    else:
        raise ValueError(f"no decode path for device {device}")
    if emit == "pixels":
        return [part.views(flat) for part in parts], err
    return [outs[sp] for sp in layout.out_order], err


def decode_lanes_to_planes(
    plan: LanePlan, geoms: Optional[Sequence[ImageGeom]], device, *, plain: bool = False
) -> Tuple[List, torch.Tensor]:
    """Decode every lane of `plan` on `device`. Returns (planes, err):
    per component, uint8[N, padded_h, padded_w] sample planes (the
    reference's assemble_pixels_stacked layout, frame component order),
    and the per-lane error bits int32[L]. On a CUDA device this launches
    kernel A; on the CPU it runs the plain version. ``plain=True`` runs
    the plain version on any device, to hold the kernel to it. For a plan
    with parts (``combine_plans``; `geoms` unused) one launch decodes
    every part, and planes holds each part's list of planes in turn: views
    of one flat output per scan component."""
    parts, err = _decode_lanes(plan, geoms, device, plain, "pixels")
    return (parts if plan.parts is not None else parts[0]), err


def decode_lanes_to_coeffs(
    plan: LanePlan, geoms: Sequence[ImageGeom], device, *, plain: bool = False,
    layout: Optional[PlaneLayout] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Decode every lane of `plan` on `device` to coefficients. Returns
    (coeffs, err): per scan component (frame component order for an
    interleaved scan), int32 [N, padded_hb*padded_wb, 64] zigzag blocks
    with absolute DCs, the reference's ``assemble`` layout (pad blocks of
    a non-interleaved grid stay 0), and the per-lane error bits int32[L].
    On a CUDA device this launches kernel 2; on the CPU it runs the
    plain version; ``plain=True`` runs the plain version on any device.
    `layout` (default: the first image's) places the blocks; a layout
    whose planes hold fewer rows takes a plan whose MCU indices start at
    its first row (``decode_norst_sharded``'s row windows)."""
    return _decode_lanes(plan, geoms, device, plain, "coeff", layout)


# ---------------------------------------------------------------------------
# Errors and the public entries
# ---------------------------------------------------------------------------


def failures_from_err(errs: np.ndarray, lane_meta: np.ndarray) -> Dict[int, Exception]:
    """Per-lane error codes (trimmed to the real lane count) -> one
    exception per failed image; the first failing lane of an image wins,
    and within a lane BADCODE beats RUN beats TRUNC."""
    failures: Dict[int, Exception] = {}
    for lane in np.nonzero(errs)[0]:
        img = int(lane_meta[int(lane)][0])
        if img in failures:
            continue
        code = int(errs[lane])
        if code & _ERR_BADCODE:
            failures[img] = JpegHuffmanError(
                f"invalid Huffman code in segment {int(lane)} (image {img})"
            )
        elif code & _ERR_RUN:
            failures[img] = JpegHuffmanError(
                f"AC run past end of block in segment {int(lane)} (image {img})"
            )
        else:
            failures[img] = JpegTruncatedError(
                f"entropy segment {int(lane)} truncated (image {img})"
            )
    return failures


def resolve_rgb_errors(err: torch.Tensor, plan: LanePlan) -> Dict[int, Exception]:
    """Read back a decode's error vector and map it to per-image failures,
    keyed by the image's index in the plan (over every part in turn)."""
    with spans.span(spans.CARD_WAIT):
        errs = err.cpu().numpy().reshape(-1)[: plan.n_lanes]
    return failures_from_err(errs, plan.lane_meta.cpu().numpy())


def decode_group_to_rgb(plan: LanePlan, bucket_jpegs: Sequence[Sequence], config: DecodeConfig = DEFAULT_CONFIG,
                        device="cuda", packed: bool = False):
    """Kernel A and the color stage for a restart or norst plan built
    elsewhere (the stream's prep threads, the batch ladder; the reference's
    ``_rgb_chain`` and its call): `bucket_jpegs` holds the images of each
    part of the plan in order, one list for a plan of one geometry. Kernel
    A runs once over every part, then the color stage once per part on its
    views of the flat planes. Copies the plan to `device` without blocking
    (asynchronous from pinned memory: keep `plan` alive until the stream
    has passed the launches) and reads nothing back. Returns (rgb per
    part, layout, err): each rgb uint8 [n, H, W, 3] (or [n, H, W] gray) on
    `device` with layout "nhwc", or, with `packed` where
    ``pipeline.packed_layout_applies``, planar uint16 [n, 3, H, W/2] with
    layout "packed16" (the last part's layout: one where `packed` applies
    to every part); err the per-lane error bits int32[L] of the whole plan
    for ``resolve_rgb_errors``."""
    from . import pipeline

    device = torch.device(device)
    parts, err = _decode_lanes(plan.to(device, non_blocking=True), [ImageGeom.of(j) for j in bucket_jpegs[0]],
                               device, False, "pixels")
    rgbs = [pipeline.transform_planes_batch(js[0].frame, planes, config, color=bitstream.color_space(js[0]),
                                            packed=packed)
            for planes, js in zip(parts, bucket_jpegs)]
    return rgbs, pipeline.layout_of(rgbs[-1]), err


def decode_batch_to_rgb(jpegs: Sequence, config: DecodeConfig = DEFAULT_CONFIG,
                        defer_errors: bool = False, device="cuda"):
    """Fused decode of a uniform batch of parsed baseline JPEGs
    (``tpujpeg_torch.bitstream.parse``) on `device`: kernel A to component
    planes, then upsample + color (``decode_group_to_rgb``). Returns ([N,
    H, W, 3] or [N, H, W] uint8 on `device`, {image index: exception}).
    With `defer_errors` the second element is instead the (err, plan) pair
    for ``resolve_rgb_errors``: nothing is read back, so a caller can
    launch several batches before it waits on any."""
    plan = build_block_plan(jpegs)
    if int(plan.qsets.shape[0]) > MAX_QSETS:
        raise JpegUnsupportedError(
            f"fused pixels mode takes at most {MAX_QSETS} distinct quantizer sets per batch"
        )
    (rgb,), _layout, err = decode_group_to_rgb(plan, [jpegs], config, device)
    if defer_errors:
        return rgb, (err, plan)
    return rgb, resolve_rgb_errors(err, plan)


def decode_batch_to_coeffs(
    jpegs: Sequence, config: DecodeConfig = DEFAULT_CONFIG, strict: bool = True, device="cuda"
) -> Tuple[List[torch.Tensor], Dict[int, Exception]]:
    """Coefficient decode of a uniform batch of parsed baseline JPEGs on
    `device` (kernel 2), in the batch layout ``pipeline.transform_batch``
    takes. Returns (per frame component, int32 [N, padded_blocks, 64]
    zigzag coefficients on `device`, whose rows for a failed image are
    garbage; {image index: exception}). With `strict`, the first failure
    raises instead."""
    plan = build_block_plan(jpegs)
    geoms = [ImageGeom.of(j) for j in jpegs]
    coeffs, err = decode_lanes_to_coeffs(plan, geoms, device)
    failures = resolve_rgb_errors(err, plan)
    if strict and failures:
        raise failures[min(failures)]
    return coeffs, failures


def decode_batch_to_device(
    jpegs: Sequence, config: DecodeConfig = DEFAULT_CONFIG, strict: bool = True, device="cuda"
) -> Tuple[List[Optional[List[torch.Tensor]]], Dict[int, Exception]]:
    """``decode_batch_to_coeffs`` split per image, the reference's
    layout: (per image, per frame component, int32 [padded_blocks, 64]
    zigzag coefficients on `device`, or None for a failed image;
    {image index: exception}). The per-image tensors are views of the
    batch arrays."""
    coeffs, failures = decode_batch_to_coeffs(jpegs, config, strict, device)
    results: List[Optional[List[torch.Tensor]]] = [
        None if i in failures else [c[i] for c in coeffs] for i in range(len(jpegs))
    ]
    return results, failures


def decode_norst_to_device(jpeg, config: DecodeConfig = DEFAULT_CONFIG, every: int = 0,
                           device="cuda") -> List[torch.Tensor]:
    """Coefficient decode of one baseline scan the restart planner refuses
    (no restart markers, or segments over the row cap) on `device`:
    ``build_norst_plan`` on the host, then kernel 2 over its lanes, each
    block written at its raster index with its true DC. Returns per frame
    component (scan component for a non-interleaved scan) int32
    [padded_blocks, 64] zigzag coefficients. Raises the lowest failing
    lane's error."""
    plan = build_norst_plan(jpeg, every)
    coeffs, err = decode_lanes_to_coeffs(plan, [ImageGeom.of(jpeg)], device)
    failures = resolve_rgb_errors(err, plan)
    if failures:
        raise failures[0]
    return [c[0] for c in coeffs]


def decode_norst_to_rgb(jpeg, config: DecodeConfig = DEFAULT_CONFIG, every: int = 0,
                        packed: bool = False, device="cuda"):
    """Fused decode of one baseline scan the restart planner refuses on
    `device`: ``build_norst_plan``, then kernel A and the color stage
    (``decode_group_to_rgb``). On a CUDA device `every` 0 takes the card's
    split (``card_norst_plan``); elsewhere, or with `every` given, the
    reference's. Returns uint8 [H, W, 3] (or [H, W] gray) on `device`, or
    with `packed` where ``pipeline.packed_layout_applies`` the planar
    uint16 [3, H, W/2] whose bytes are the raster. Raises the lowest
    failing lane's error."""
    device = torch.device(device)
    if every <= 0 and device.type == "cuda":
        plan = card_norst_plan(jpeg, device)
    else:
        plan = build_norst_plan(jpeg, every)
    (rgb,), _layout, err = decode_group_to_rgb(plan, [[jpeg]], config, device, packed)
    failures = resolve_rgb_errors(err, plan)
    if failures:
        raise failures[0]
    return rgb[0]


# ---------------------------------------------------------------------------
# Sharded entries: one process, a mesh of devices (parallel/mesh.py)
# ---------------------------------------------------------------------------


def _norst_window(plan: LanePlan, lo: int, hi: int, layout: PlaneLayout):
    """Lanes [lo, hi) of a norst plan as a plan of their own that starts
    every lane with zero DC predictors (``dc0`` zeroed), and the layout of
    the rows their MCUs touch: layout rows (MCU rows; block rows of a
    non-interleaved scan) [r0, r1), with the plan's MCU indices counted
    from row r0. Returns (plan, layout, r0)."""
    meta = plan.lane_meta[lo:hi].clone()
    m0, m1 = int(meta[0, 1]), int(meta[-1, 1] + meta[-1, 2])
    r0, r1 = m0 // layout.mcus_x, -(-m1 // layout.mcus_x)
    meta[:, 1] -= r0 * layout.mcus_x
    sub = dataclasses.replace(
        plan, bits=plan.bits[lo:hi], seg_bits=plan.seg_bits[lo:hi], lane_m=plan.lane_m[lo:hi],
        lane_qset=plan.lane_qset[lo:hi], lane_meta=meta, bit0=plan.bit0[lo:hi],
        dc0=torch.zeros_like(plan.dc0[lo:hi]), n_mcus=int(plan.lane_m[lo:hi].max()),
        lane_seg=plan.lane_seg[lo:hi], seg_first=None,
    )
    win = dataclasses.replace(
        layout, comp=tuple((h, v, (r1 - r0) * v * 8, pw) for h, v, _ph, pw in layout.comp))
    return sub, win, r0


def _lane_dc_totals(coeffs: Sequence[torch.Tensor], plan: LanePlan, layout: PlaneLayout) -> torch.Tensor:
    """int32 [L, C]: per lane, the DC of each component's last block in
    the lane's last MCU, which, decoded from zero predictors, is the sum
    of the lane's DC deltas of that component. coeffs are
    ``decode_lanes_to_coeffs``' outputs (frame component order)."""
    dev = coeffs[0].device
    meta = plan.lane_meta.to(dev, torch.int64)
    g = meta[:, 1] + meta[:, 2] - 1
    my, mx = g // layout.mcus_x, g % layout.mcus_x
    cols = []
    for out, sp in zip(coeffs, layout.out_order):
        h, v, _ph, pw = layout.comp[sp]
        cols.append(out[0, (my * v + v - 1) * (pw // 8) + mx * h + h - 1, 0])
    return torch.stack(cols, dim=1)


def _add_lane_dc(coeffs: Sequence[torch.Tensor], plan: LanePlan, layout: PlaneLayout,
                 add: torch.Tensor) -> None:
    """Add add[l, c] (int32 [L, C]) to the DC of every block of component
    c in lane l's MCUs, in place; blocks of no lane of the plan (the
    window's rows outside it, pad columns) stay as they are."""
    dev = coeffs[0].device
    m0, total = int(plan.lane_meta[0, 1]), int(plan.lane_m.sum())
    _h0, v0, ph0, _pw0 = layout.comp[0]
    mcu_add = torch.zeros((ph0 // 8 // v0 * layout.mcus_x, add.shape[1]), dtype=torch.int32, device=dev)
    mcu_add[m0 : m0 + total] = torch.repeat_interleave(
        add, plan.lane_m.to(dev, torch.int64), dim=0, output_size=total)
    for c, (out, sp) in enumerate(zip(coeffs, layout.out_order)):
        h, v, ph, pw = layout.comp[sp]
        br = torch.arange(ph // 8, device=dev)[:, None]
        bc = torch.arange(pw // 8, device=dev)[None, :]
        mcu = (br // v) * layout.mcus_x + torch.clamp(bc // h, max=layout.mcus_x - 1)
        out[0, :, 0] += torch.where(bc < layout.mcus_x * h, mcu_add[mcu, c], 0).reshape(-1)


def decode_norst_sharded(jpeg, config: DecodeConfig = DEFAULT_CONFIG, every: int = 0,
                         mesh=None) -> List[torch.Tensor]:
    """Coefficient decode of one marker-free baseline scan with its lanes
    sharded over `mesh` (default: every visible CUDA device; it raises
    without a card). ``build_norst_plan`` runs once; shard i takes the
    contiguous lanes [i * per, (i + 1) * per), per = ceil(lanes / shards)
    (the reference's padding lanes decode nothing, so none are made, and
    a shard past the last lane does no work), and runs kernel 2 on them
    from zero DC predictors, never the plan's primed ``dc0``, into the
    rows its MCUs touch. Then the reference's fixup: each lane's DC
    total, an exclusive prefix within the shard, ``halo.dc_prefix_fixup``
    across shards, and the sum added to every DC of the lane. Returns per
    frame component (scan component for a non-interleaved scan) int32
    [padded_blocks, 64] zigzag coefficients on ``mesh[0]``, equal to
    ``decode_norst_to_device``'s. Raises JpegUnsupportedError on a
    restart-segmented scan, as the reference does, and the lowest failing
    lane's error."""
    from ..parallel import halo, mesh as mesh_lib

    mesh = mesh_lib.data_mesh(mesh)
    if jpeg.scans and len(jpeg.scans[0].rst_offsets):
        # One predictor chain across shards: restart-segmented streams
        # with oversize segments take the single-device segmented path.
        raise JpegUnsupportedError("sharded skeleton decode: marker-free streams only")
    plan = build_norst_plan(jpeg, every)
    geoms = [ImageGeom.of(jpeg)]
    layout = PlaneLayout.of(geoms[0])
    per = -(-plan.n_lanes // len(mesh))
    shards = []
    for s, dev in enumerate(mesh):
        lo, hi = s * per, min(plan.n_lanes, (s + 1) * per)
        if lo >= hi:
            break
        sub, win, r0 = _norst_window(plan, lo, hi, layout)
        coeffs, err = decode_lanes_to_coeffs(sub, geoms, dev, layout=win)
        shards.append((sub, win, r0, coeffs, err))
    totals = [_lane_dc_totals(coeffs, sub, win) for sub, win, _r0, coeffs, _err in shards]
    bases = halo.dc_prefix_fixup([t.sum(0).to(torch.int32) for t in totals])
    for (sub, win, _r0, coeffs, _err), tot, base in zip(shards, totals, bases):
        _add_lane_dc(coeffs, sub, win, (torch.cumsum(tot, 0) - tot + base).to(torch.int32))
    # Each shard's rows added into the whole grid: a block outside a
    # shard's lanes is 0 there.
    out = []
    for c, sp in enumerate(layout.out_order):
        _h, v, ph, pw = layout.comp[sp]
        full = torch.zeros((ph // 8, pw // 8, 64), dtype=torch.int32, device=mesh[0])
        for _sub, _win, r0, coeffs, _err in shards:
            part = coeffs[c].to(mesh[0], non_blocking=True).view(-1, pw // 8, 64)
            full[r0 * v : r0 * v + part.shape[0]] += part
        out.append(full.view(-1, 64))
    errs = np.concatenate([err.cpu().numpy() for *_x, err in shards])
    failures = failures_from_err(errs, plan.lane_meta.numpy())
    if failures:
        raise failures[0]
    return out


def decode_batch_to_rgb_sharded(jpegs: Sequence, config: DecodeConfig = DEFAULT_CONFIG, mesh=None):
    """Data-parallel fused decode of a uniform batch over `mesh` (default:
    every visible CUDA device; it raises without a card): the list splits
    into one contiguous chunk per device, and each device runs kernel A
    and the color stage on its chunk (``decode_group_to_rgb``). Refuses,
    as the reference does (JpegUnsupportedError), a batch whose length
    the mesh does not divide, more quantizer sets than kernel A takes,
    and chunks whose table sets, quantizer sets, per-image quantizer
    choice or MCUs per lane differ (the rows' word count may differ).
    Returns (per mesh entry, uint8 [per, H, W, 3] (or [per, H, W] gray)
    on that device; {image index over the whole batch: exception})."""
    from ..parallel import mesh as mesh_lib

    mesh = mesh_lib.data_mesh(mesh)
    d, n = len(mesh), len(jpegs)
    if n % d != 0:
        raise JpegUnsupportedError(f"sharded decode needs len(jpegs) % {d} == 0, got {n}")
    per = n // d
    chunks = [jpegs[i * per : (i + 1) * per] for i in range(d)]
    plans = [build_block_plan(c) for c in chunks]
    p0 = plans[0]
    if int(p0.qsets.shape[0]) > MAX_QSETS:
        raise JpegUnsupportedError("sharded decode: too many quantizer sets")
    for p in plans[1:]:
        if (p.blk_tables != p0.blk_tables or not torch.equal(p.qsets, p0.qsets)
                or p.img_qset != p0.img_qset or p.n_mcus != p0.n_mcus):
            raise JpegUnsupportedError("sharded decode needs identical chunk structure")
    launched = [decode_group_to_rgb(p, [c], config, dev) for p, c, dev in zip(plans, chunks, mesh)]
    failures: Dict[int, Exception] = {}
    for di, ((_rgbs, _layout, err), p) in enumerate(zip(launched, plans)):
        for img, exc in resolve_rgb_errors(err, p).items():
            failures.setdefault(di * per + img, exc)
    return [rgbs[0] for rgbs, _layout, _err in launched], failures


def decode_multiscan_to_device(jpeg, config: DecodeConfig = DEFAULT_CONFIG,
                               device="cuda") -> List[torch.Tensor]:
    """A baseline frame split into per-component non-interleaved scans:
    each scan decodes with kernel 2 as its own one-component frame over
    the component's (dwidth, dheight) sample grid (through
    ``decode_norst_to_device`` where the restart planner refuses it), and
    its block grid is padded with zero blocks into the frame's MCU-padded
    grid. Returns per frame component int32 [padded_blocks, 64] zigzag
    coefficients on `device`. Raises on data errors."""
    frame = jpeg.frame
    grids: Dict[int, torch.Tensor] = {}
    for scan in jpeg.scans:
        if scan.n_comps != 1:
            raise JpegUnsupportedError("interleaved sub-scan in a multi-scan file")
        ci = scan.comp_indices[0]
        c = frame.components[ci]
        subframe = bitstream.Frame(
            progressive=False, precision=frame.precision, height=c.dheight, width=c.dwidth,
            components=[bitstream.Component(index=0, cid=c.cid, h=1, v=1, tq=c.tq)],
        )
        subframe.finalize()
        sub = bitstream.JpegData(
            frame=subframe, scans=[dataclasses.replace(scan, comp_indices=[0])],
            qtables=jpeg.qtables, restart_interval=scan.restart_interval,
        )
        try:
            comps, _ = decode_batch_to_device([sub], config, strict=True, device=device)
            grid = comps[0][0]
        except JpegUnsupportedError:
            grid = decode_norst_to_device(sub, config, device=device)[0]
        sc = subframe.components[0]
        grid = grid.reshape(sc.padded_hb, sc.padded_wb, 64)
        grid = torch.nn.functional.pad(
            grid, (0, 0, 0, c.padded_wb - sc.padded_wb, 0, c.padded_hb - sc.padded_hb)
        )
        grids[ci] = grid.reshape(-1, 64)
    out: List[torch.Tensor] = []
    for ci in range(frame.n_components):
        if ci not in grids:
            raise JpegTruncatedError(f"multi-scan file has no scan for component {ci}")
        out.append(grids[ci])
    return out


def decode_all_scans(jpeg, config: DecodeConfig = DEFAULT_CONFIG,
                     device="cuda") -> List[torch.Tensor]:
    """The wavefront entropy engine for one image: per frame component,
    int32 [padded_blocks, 64] zigzag coefficients on `device`. A
    progressive frame runs its scans through kernels 7-9
    (``wavefront_prog.decode_all_scans``), and its DC columns are merged
    into coefficient 0; a multi-scan baseline frame decodes per component
    (``decode_multiscan_to_device``); any other through kernel 2, on the
    norst plan (``decode_norst_to_device``) where the restart planner
    refuses its one scan (marker-free files, huge restart intervals)."""
    if jpeg.frame.progressive:
        from . import wavefront_prog

        acs, dcs = wavefront_prog.decode_all_scans(jpeg, device)
        for ac, dc in zip(acs, dcs):
            ac[:, 0] = dc
        return acs
    if len(jpeg.scans) > 1 and all(s.n_comps == 1 for s in jpeg.scans):
        return decode_multiscan_to_device(jpeg, config, device)
    try:
        comps, _ = decode_batch_to_device([jpeg], config, strict=True, device=device)
    except JpegUnsupportedError:
        if len(jpeg.scans) != 1:
            raise
        return decode_norst_to_device(jpeg, config, device=device)
    return comps[0]
