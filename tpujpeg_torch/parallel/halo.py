"""One giant image decoded with its MCU rows sharded over a mesh of
devices, each shard with one MCU row of its neighbours either side, and
the DC-predictor prefix fixup across shards.

Port of ``tpujpeg/parallel/halo.py``. A mesh is a tuple of
``torch.device`` (``parallel/mesh.py``) driven from one process. The
reference's masked ``all_gather`` gathers the per-shard totals onto
``mesh[0]``, takes an exclusive ``cumsum`` and copies each result back.
PyTorch orders a copy between two CUDA devices with events on both
devices' current streams, so no copy waits on the host.

Each shard runs kernel 6 on its window: its own coefficient rows and one
MCU row more either side, clipped at the image's edges
(``shard_windows``). The single-device color stage
(``pipeline.transform_planes_batch``: kernel B, C or D, or the plain tail
for every other sampling and color space) runs on the window, and the
shard keeps its own rows. Every upsampler reads at most one sample row
either side, so this gives the bytes of the unsharded decode on every
sampling, and the image's top and bottom edges are the window's. The
reference exchanges halo rows between shards (``ppermute``) because a
shard_map shard holds only its own rows; here one process holds the
whole coefficient grid, so a shard decodes its neighbours' edge rows
itself, at two MCU rows of kernel 6 and color work more per shard. (The
reference upsamples fancily only at h2v2 and h2v1 and always converts a
3-component frame as YCbCr; the port follows ``decode()`` and PIL.)
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import bitstream
from ..config import DEFAULT_CONFIG, DecodeConfig
from ..errors import JpegUnsupportedError
from ..kernels import idct, pipeline
from . import mesh as mesh_lib


def dc_prefix_fixup(local_totals: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Exclusive prefix sum of per-shard DC-delta totals across shards.
    local_totals[i]: int [C] on shard i's device, the sum of the DC deltas
    shard i decoded from zero predictors. Returns, on each shard's device,
    the sum of the totals of shards j < i: the base to add to every DC
    shard i decoded."""
    dev0 = local_totals[0].device
    allv = torch.stack([t.to(dev0, non_blocking=True) for t in local_totals])
    excl = (torch.cumsum(allv, dim=0) - allv).to(allv.dtype)
    return [excl[i].to(t.device, non_blocking=True) for i, t in enumerate(local_totals)]


def shard_spans(frame, n_shards: int) -> List[Tuple[int, int]]:
    """Each shard's MCU rows [first, end): the row count padded up to a
    multiple of `n_shards` (``(-mcus_y) % n_shards`` rows, as the
    reference pads) and split evenly. A shard made only of padding gets
    an empty span and does no work."""
    k = -(-frame.mcus_y // n_shards)
    return [(min(s * k, frame.mcus_y), min((s + 1) * k, frame.mcus_y)) for s in range(n_shards)]


def shard_windows(frame, n_shards: int) -> List[Tuple[int, int, int, int]]:
    """Per shard with rows, in shard order: (first, end) of the MCU rows
    it outputs (``shard_spans``) and (first, end) of the MCU rows it
    decodes, one more either side, clipped at the image's edges."""
    return [(a, b, max(a - 1, 0), min(b + 1, frame.mcus_y))
            for a, b in shard_spans(frame, n_shards) if a < b]


def _sub_frame(frame, height: int):
    """The frame's components at another height: the geometry of one
    shard's window."""
    sub = bitstream.Frame(
        progressive=False, precision=frame.precision, height=height, width=frame.width,
        components=[bitstream.Component(index=c.index, cid=c.cid, h=c.h, v=c.v, tq=c.tq)
                    for c in frame.components],
    )
    sub.finalize()
    return sub


def shard_planes(frame, coeffs: Sequence, qtabs: Sequence, mesh: Sequence) -> List[List[torch.Tensor]]:
    """Kernel 6 on each shard's window of coefficient rows
    (``shard_windows``), on its device. coeffs[ci]: zigzag int32
    [padded_blocks, 64] per frame component and qtabs[ci]: its zigzag
    int32 [64] quantizer (tensors on any device, or host arrays). Returns
    per shard with rows, per component, uint8 [1, rows, padded_w] sample
    planes of the window, cropped to the image's sample rows."""
    planes: List[List[torch.Tensor]] = []
    for dev, (_a, _b, wa, wb) in zip(mesh, shard_windows(frame, len(mesh))):
        per_c = []
        for c, cf, qt in zip(frame.components, coeffs, qtabs):
            grid = torch.as_tensor(cf).reshape(c.padded_hb, c.padded_wb, 64)
            blk = grid[wa * c.v : wb * c.v].to(dev, non_blocking=True).reshape(1, -1, 64)
            q = torch.as_tensor(qt, dtype=torch.int32).to(dev, non_blocking=True)
            plane = idct.dequant_idct_islow(blk, q, (wb - wa) * c.v, c.padded_wb)
            per_c.append(plane[:, : min(wb * c.v * 8, c.dheight) - wa * c.v * 8])
        planes.append(per_c)
    return planes


def color_shards(frame, planes: Sequence[Sequence[torch.Tensor]], config: DecodeConfig,
                 mesh: Sequence, color: Optional[str] = None) -> torch.Tensor:
    """From ``shard_planes``' planes: the color stage on each shard's
    window, on its device, and the shard's own rows copied into the image
    on ``mesh[0]``. `color` as ``pipeline.transform_planes_batch`` takes
    it (default: from the component count). Returns uint8 [H, W, 3] (or
    [H, W] gray, [H, W, 4] CMYK/YCCK)."""
    row = frame.vmax * 8
    out: Optional[torch.Tensor] = None
    for (a, b, wa, wb), win in zip(shard_windows(frame, len(mesh)), planes):
        rows = min(b * row, frame.height) - a * row
        sub = _sub_frame(frame, min(wb * row, frame.height) - wa * row)
        img = pipeline.transform_planes_batch(sub, win, config, color=color)[0]
        img = img[(a - wa) * row : (a - wa) * row + rows]
        if out is None:
            out = torch.empty((frame.height,) + tuple(img.shape[1:]), dtype=img.dtype, device=mesh[0])
        out[a * row : a * row + rows].copy_(img, non_blocking=True)
    return out


def sharded_transform(frame, coeffs: Sequence, qtabs: Sequence, config: DecodeConfig, mesh: Sequence,
                      color: Optional[str] = None) -> torch.Tensor:
    """One image's transform with its MCU rows sharded over `mesh`, from
    its coefficients: ``shard_planes`` (kernel 6 on each shard's window)
    and ``color_shards`` (the color stage on it, each shard's rows copied
    into the image on ``mesh[0]``); the counterpart of the reference's
    ``_build_sharded_transform``. coeffs[ci], qtabs[ci] and `color` as
    those take them. Returns the image on ``mesh[0]``: uint8 [H, W, 3]
    (or [H, W] gray, [H, W, 4] CMYK/YCCK), exactly H rows (no padding
    rows, where the reference's has them)."""
    mesh = mesh_lib.as_mesh(mesh)
    return color_shards(frame, shard_planes(frame, coeffs, qtabs, mesh), config, mesh, color)


def decode_sharded(data: bytes, n_shards: Optional[int] = None, config: DecodeConfig = DEFAULT_CONFIG,
                   mesh: Optional[Sequence] = None):
    """Decode one JPEG byte string with its MCU rows sharded over `mesh`
    (default: every visible CUDA device, repeated to `n_shards` shards if
    given; it raises without a card). Entropy as the reference routes
    it: a restart-segmented baseline scan through kernel 2 once on
    ``mesh[0]`` (``decode_batch_to_device``), a marker-free single scan
    through ``decode_norst_sharded`` (kernel 2 per shard, DC base across
    shards by ``dc_prefix_fixup``); where those refuse the stream
    (``JpegUnsupportedError``), ``decode_norst_to_device`` on ``mesh[0]``,
    then host entropy. Then ``sharded_transform``: kernel 6 and the color
    stage on each shard's window. Returns uint8 [H, W, 3] (or [H, W]
    gray, [H, W, 4] CMYK/YCCK): numpy under ``config.to_numpy``, else a
    tensor on ``mesh[0]``. Like the
    reference's, it ignores ``transform_engine`` and ``idct``."""
    from ..decoder import _entropy_decode
    from ..kernels import wavefront as wf
    from ..stats import DecodeStats

    if mesh is None:
        devs = mesh_lib.rows_mesh()
        mesh = tuple(devs[i % len(devs)] for i in range(n_shards or len(devs)))
    else:
        mesh = mesh_lib.as_mesh(mesh)
        if n_shards is not None and n_shards != len(mesh):
            raise ValueError(f"n_shards={n_shards} but the mesh has {len(mesh)} devices")
    jpeg = bitstream.parse(data)
    frame = jpeg.frame

    coeffs = None
    if not frame.progressive and config.entropy_engine in ("auto", "wavefront"):
        try:
            if len(jpeg.scans) == 1 and len(jpeg.scans[0].rst_offsets) == 0:
                coeffs = wf.decode_norst_sharded(jpeg, config, mesh=mesh)
            else:
                comps, _ = wf.decode_batch_to_device([jpeg], config, strict=True, device=mesh[0])
                coeffs = comps[0]
        except JpegUnsupportedError:
            try:
                coeffs = wf.decode_norst_to_device(jpeg, config, device=mesh[0])
            except JpegUnsupportedError:
                coeffs = None
    if coeffs is None:
        coeffs = _entropy_decode(jpeg, config, DecodeStats(), mesh[0])
    qtabs = [torch.from_numpy(jpeg.qtables[c.tq].astype("int32")) for c in frame.components]
    out = sharded_transform(frame, coeffs, qtabs, config, mesh, bitstream.color_space(jpeg))
    return out.cpu().numpy() if config.to_numpy else out
