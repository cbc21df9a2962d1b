"""Reference decode of one JPEG: ``coefficients`` (host, numpy only, so a
worker process needs no torch) and ``rgb`` (the plain transform on any
torch device; torch is imported there)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import bitstream, huffman


def coefficients(data: bytes) -> List[np.ndarray]:
    """Per frame component, the zigzag coefficients int16
    [padded_hb * padded_wb, 64] of every scan of `data` (8-bit JPEG
    coefficients fit 16 bits, as libjpeg's JCOEF)."""
    return [c.astype(np.int16) for c in huffman.decode_all_scans(bitstream.parse(data))]


def rgb(data: bytes, coeffs: Sequence[np.ndarray], device, idct: str = "islow"):
    """uint8 [H, W, 3] on `device` from `data`'s headers and its
    coefficients, with libjpeg's islow IDCT and fancy upsampling, or the
    float IDCT with ``idct="float"`` (the control)."""
    import torch

    from . import transform

    jpeg = bitstream.parse(data)
    frame = jpeg.frame
    cs = [torch.from_numpy(c).to(device=device, dtype=torch.int32) for c in coeffs]
    qs = [torch.from_numpy(jpeg.qtables[c.tq].astype(np.int32)).to(device) for c in frame.components]
    return transform.transform_frame(frame, cs, qs, True, bitstream.color_space(jpeg), idct=idct)
