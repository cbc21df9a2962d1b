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
takes the plain ``transform.py`` tail.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import transform as T
from ..config import DecodeConfig
from . import idct as idct_k
from . import sample_color as sc


def _color_stage(frame, expansions, planes: Sequence[torch.Tensor], fancy: bool,
                 color: str) -> torch.Tensor:
    if color == "gray":
        return planes[0][:, : frame.height, : frame.width]
    if color == "ycbcr" and frame.n_components == 3 and fancy:
        kernel = {
            ((1, 1), (2, 2), (2, 2)): sc.upsample_color_h2v2,
            ((1, 1), (2, 1), (2, 1)): sc.upsample_color_h2v1,
            ((1, 1), (1, 1), (1, 1)): sc.color_444,
        }.get(tuple(expansions))
        if kernel is not None:
            return kernel(*planes)
    ups: List[torch.Tensor] = []
    for plane, (he, ve) in zip(planes, expansions):
        up = T.upsample_component(plane, he, ve, fancy=fancy)
        ups.append(up[..., : frame.height, : frame.width])
    return T.finish_color(ups, color)


def transform_planes_batch(frame, planes: Sequence[torch.Tensor], config: DecodeConfig,
                           color: Optional[str] = None) -> torch.Tensor:
    """planes[ci]: uint8[N, padded_h, padded_w] sample planes in frame
    component order. Returns uint8[N, H, W, 3] (or [N, H, W] gray,
    [N, H, W, 4] CMYK/YCCK) on the planes' device."""
    if color is None:
        color = T.default_color(frame.n_components)
    expansions = [(frame.hmax // c.h, frame.vmax // c.v) for c in frame.components]
    cropped = [p[:, : c.dheight, : c.dwidth] for p, c in zip(planes, frame.components)]
    return _color_stage(frame, expansions, cropped, config.fancy_upsampling, color)


def transform_batch(frame, coeffs: Sequence[torch.Tensor], qtabs: Sequence[torch.Tensor],
                    config: DecodeConfig, color: Optional[str] = None,
                    dcs: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """coeffs[ci]: int32 [N, padded_blocks, 64] zigzag; qtabs[ci]: int32
    [64], or [N, 64] for per-image quantizers; dcs[ci] (optional): int32
    [N, padded_blocks] DC columns merged into coefficient slot 0. All on
    one device. Returns uint8 [N, H, W, 3] (or [N, H, W] gray,
    [N, H, W, 4] CMYK/YCCK) there: kernel 6 (or the float matmul variant
    with ``config.idct == 'matmul'``) to sample planes, then the color
    stage."""
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
    return transform_planes_batch(frame, planes, config, color=color)


def transform_frame(frame, coeffs: Sequence[torch.Tensor], qtabs: Sequence[torch.Tensor],
                    config: DecodeConfig, color: Optional[str] = None) -> torch.Tensor:
    """One image: coeffs[ci] int32 [padded_blocks, 64], qtabs[ci] [64]."""
    return transform_batch(frame, [c[None] for c in coeffs], qtabs, config, color=color)[0]
