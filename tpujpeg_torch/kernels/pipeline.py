"""Coefficients or sample planes -> RGB/gray/CMYK raster for a batch of
one geometry.

Port of ``transform_batch``/``transform_frame`` (the staged path:
kernel 6, then the color stage) and ``transform_planes_batch``/
``_color_stage`` (the fused path's tail) in
``tpujpeg/kernels/pipeline.py``. Each plane is cropped to its
component's (dheight, dwidth) before upsampling (libjpeg's edge rule),
as a view. The split is the reference's: YCbCr with fancy upsampling at
4:2:0, 4:2:2 and 4:4:4 goes to kernels B, C and D; gray is a crop;
everything else (non-fancy, RGB, CMYK, YCCK, other sampling ratios)
takes the plain ``transform.py`` tail. With ``packed`` and where
``packed_layout_applies`` (YCbCr, 3 components, fancy, 4:2:0 or 4:2:2,
even width) the planar kernels replace B and C and the output is the
reference's packed16 layout: planar uint16 [N, 3, H, W/2] whose
little-endian bytes are the planar uint8 raster.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import transform as T
from ..config import DecodeConfig
from . import idct as idct_k
from . import sample_color as sc


_H2V2 = ((1, 1), (2, 2), (2, 2))
_H2V1 = ((1, 1), (2, 1), (2, 1))
# YCbCr with fancy upsampling, by component expansions.
_NHWC_KERNELS = {_H2V2: sc.upsample_color_h2v2, _H2V1: sc.upsample_color_h2v1,
                 ((1, 1), (1, 1), (1, 1)): sc.color_444}
_PACKED_KERNELS = {_H2V2: sc.upsample_color_h2v2_packed, _H2V1: sc.upsample_color_h2v1_packed}


def _expansions(frame) -> Tuple[Tuple[int, int], ...]:
    return tuple((frame.hmax // c.h, frame.vmax // c.v) for c in frame.components)


def _ycbcr_fancy(frame, config: DecodeConfig, color: str) -> bool:
    return color == "ycbcr" and frame.n_components == 3 and config.fancy_upsampling


def packed_layout_applies(frame, config: DecodeConfig, color: str) -> bool:
    """True iff the color stage honors packed=True for this frame: the
    fused 4:2:0/4:2:2 upsample + color kernels with an even frame width.
    Callers use it to know the output's form before they ask for it."""
    return (_ycbcr_fancy(frame, config, color) and frame.width % 2 == 0
            and _expansions(frame) in _PACKED_KERNELS)


def layout_of(rgb: torch.Tensor) -> str:
    """The layout the color stage gave: "packed16" for its planar uint16
    words, else "nhwc"."""
    return "packed16" if rgb.dtype == torch.uint16 else "nhwc"


def _color_stage(frame, planes: Sequence[torch.Tensor], config: DecodeConfig, color: str,
                 packed: bool = False) -> torch.Tensor:
    if color == "gray":
        return planes[0][:, : frame.height, : frame.width]
    if packed and packed_layout_applies(frame, config, color):
        return _PACKED_KERNELS[_expansions(frame)](*planes)
    expansions = _expansions(frame)
    if _ycbcr_fancy(frame, config, color) and expansions in _NHWC_KERNELS:
        return _NHWC_KERNELS[expansions](*planes)
    ups: List[torch.Tensor] = []
    for plane, (he, ve) in zip(planes, expansions):
        up = T.upsample_component(plane, he, ve, fancy=config.fancy_upsampling)
        ups.append(up[..., : frame.height, : frame.width])
    return T.finish_color(ups, color)


def transform_planes_batch(frame, planes: Sequence[torch.Tensor], config: DecodeConfig,
                           color: Optional[str] = None, packed: bool = False) -> torch.Tensor:
    """planes[ci]: uint8[N, padded_h, padded_w] sample planes in frame
    component order. Returns uint8[N, H, W, 3] (or [N, H, W] gray,
    [N, H, W, 4] CMYK/YCCK) on the planes' device; with `packed`, where
    ``packed_layout_applies``, planar uint16 [N, 3, H, W/2]."""
    if color is None:
        color = T.default_color(frame.n_components)
    cropped = [p[:, : c.dheight, : c.dwidth] for p, c in zip(planes, frame.components)]
    return _color_stage(frame, cropped, config, color, packed)


def transform_batch(frame, coeffs: Sequence[torch.Tensor], qtabs: Sequence[torch.Tensor],
                    config: DecodeConfig, color: Optional[str] = None,
                    dcs: Optional[Sequence[torch.Tensor]] = None, packed: bool = False) -> torch.Tensor:
    """coeffs[ci]: int32 [N, padded_blocks, 64] zigzag; qtabs[ci]: int32
    [64], or [N, 64] for per-image quantizers; dcs[ci] (optional): int32
    [N, padded_blocks] DC columns merged into coefficient slot 0. All on
    one device. Returns uint8 [N, H, W, 3] (or [N, H, W] gray,
    [N, H, W, 4] CMYK/YCCK) there: kernel 6 (or the float matmul variant
    with ``config.idct == 'matmul'``) to sample planes, then the color
    stage. `packed`: as ``transform_planes_batch``."""
    if color is None:
        color = T.default_color(frame.n_components)
    dev = coeffs[0].device
    planes: List[torch.Tensor] = []
    for ci, c in enumerate(frame.components):
        q = torch.as_tensor(qtabs[ci], dtype=torch.int32, device=dev)
        dc = dcs[ci] if dcs is not None else None
        if config.idct == "matmul":
            flat = idct_k.merge_dc(coeffs[ci], dc)
            samples = idct_k.dequant_idct_matmul(flat, idct_k.per_block_qtab(q))
            plane = T.blocks_to_plane(samples, c.padded_hb, c.padded_wb)
        else:
            plane = idct_k.dequant_idct_islow(coeffs[ci], q, c.padded_hb, c.padded_wb, dc)
        planes.append(plane)
    return transform_planes_batch(frame, planes, config, color=color, packed=packed)


def transform_frame(frame, coeffs: Sequence[torch.Tensor], qtabs: Sequence[torch.Tensor],
                    config: DecodeConfig, color: Optional[str] = None) -> torch.Tensor:
    """One image: coeffs[ci] int32 [padded_blocks, 64], qtabs[ci] [64]."""
    return transform_batch(frame, [c[None] for c in coeffs], qtabs, config, color=color)[0]
