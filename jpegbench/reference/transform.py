"""Frozen copy of ``tpujpeg_torch/transform.py`` for the benchmark's plain reference.

Sample reconstruction in plain int32 torch: dequant, islow IDCT,
upsampling and color conversion.

Port of ``tpujpeg/transform.py``. This module is the port's semantic
ground truth, as the jnp module is the reference's: the hand-written
kernels under ``tpujpeg_torch/csrc`` must match it byte for byte, and it
is also the plain tail for every color path no kernel covers (non-fancy
upsampling, RGB/CMYK/YCCK, sampling ratios other than 4:2:0, 4:2:2 and
4:4:4).

Every function works on tensors on any device and on leading batch
dimensions. All arithmetic is int32 and wraps like libjpeg's and jnp's;
torch's int32 ``>>`` is arithmetic, which ``_descale`` relies on.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from . import bitstream

# libjpeg jidctint.c fixed-point constants, CONST_BITS = 13.
CONST_BITS = 13
PASS1_BITS = 2
FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172

NATURAL_TO_ZIGZAG = torch.from_numpy(bitstream.NATURAL_TO_ZIGZAG.astype("int64"))


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """libjpeg DESCALE: round-half-up arithmetic shift."""
    return (x + (1 << (n - 1))) >> n


def _idct_1d(s: Sequence[torch.Tensor], descale_bits: int) -> List[torch.Tensor]:
    """One 8-point islow butterfly (jidctint.c structure) over 8 int32
    tensors of one shape; returns 8 tensors."""
    s0, s1, s2, s3, s4, s5, s6, s7 = s

    # Even part.
    z1 = (s2 + s6) * FIX_0_541196100
    tmp2 = z1 + s6 * (-FIX_1_847759065)
    tmp3 = z1 + s2 * FIX_0_765366865
    tmp0 = (s0 + s4) << CONST_BITS
    tmp1 = (s0 - s4) << CONST_BITS
    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    # Odd part.
    t0, t1, t2, t3 = s7, s5, s3, s1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    return [
        _descale(tmp10 + t3, descale_bits),
        _descale(tmp11 + t2, descale_bits),
        _descale(tmp12 + t1, descale_bits),
        _descale(tmp13 + t0, descale_bits),
        _descale(tmp13 - t0, descale_bits),
        _descale(tmp12 - t1, descale_bits),
        _descale(tmp11 - t2, descale_bits),
        _descale(tmp10 - t3, descale_bits),
    ]


def dequantize(coeffs_zz: torch.Tensor, qtab_zz: torch.Tensor) -> torch.Tensor:
    """coeffs_zz: int32[..., 64] zigzag coefficients; qtab_zz: int32[64]
    (or broadcastable [..., 64]) zigzag quantizer. Returns the
    natural-order dequantized int32[..., 8, 8]."""
    nat = (coeffs_zz * qtab_zz)[..., NATURAL_TO_ZIGZAG.to(coeffs_zz.device)]
    return nat.reshape(*coeffs_zz.shape[:-1], 8, 8)


def idct8x8_islow(blocks: torch.Tensor) -> torch.Tensor:
    """libjpeg islow IDCT of natural-order dequantized int32[..., 8, 8]
    blocks -> uint8[..., 8, 8] samples (+128, clamped)."""
    b = blocks.to(torch.int32)
    # Pass 1 over columns: input row i holds frequency i.
    ws = _idct_1d([b[..., i, :] for i in range(8)], CONST_BITS - PASS1_BITS)
    # Pass 2 along each workspace row.
    rows = []
    for r in range(8):
        o = _idct_1d([ws[r][..., i] for i in range(8)],
                     CONST_BITS + PASS1_BITS + 3)
        rows.append(torch.stack(o, dim=-1))
    out = torch.stack(rows, dim=-2)
    return torch.clamp(out + 128, 0, 255).to(torch.uint8)


def idct8x8_float(blocks: torch.Tensor) -> torch.Tensor:
    """The same IDCT in float32 (the orthonormal 8-point DCT-III as two
    matrix products, TF32 off, rounded to nearest): the lower precision
    that the benchmark's control decodes in. Same shapes as
    ``idct8x8_islow``."""
    k = torch.arange(8, dtype=torch.float64)
    scale = torch.where(k == 0, torch.sqrt(torch.tensor(0.125, dtype=torch.float64)), torch.tensor(0.5, dtype=torch.float64))
    # basis[x, u] = c(u) cos((2x + 1) u pi / 16)
    basis = (scale[None, :] * torch.cos((2 * k[:, None] + 1) * k[None, :] * torch.pi / 16))
    basis = basis.to(device=blocks.device, dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = basis @ blocks.to(torch.float32) @ basis.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.clamp(torch.round(out) + 128, 0, 255).to(torch.uint8)


def blocks_to_plane(samples: torch.Tensor, padded_hb: int, padded_wb: int) -> torch.Tensor:
    """[..., padded_hb*padded_wb, 8, 8] block samples -> raster plane
    [..., padded_hb*8, padded_wb*8]."""
    lead = samples.shape[:-3]
    x = samples.reshape(*lead, padded_hb, padded_wb, 8, 8)
    return x.transpose(-3, -2).reshape(*lead, padded_hb * 8, padded_wb * 8)


# ---------------------------------------------------------------------------
# Upsampling (jdsample.c semantics)
# ---------------------------------------------------------------------------


def _shift_cols(x: torch.Tensor):
    """(left, right) neighbours along the last axis, edges replicated."""
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    return left, right


def _shift_rows(x: torch.Tensor):
    """(above, below) neighbours along the second-to-last axis, edges
    replicated."""
    above = torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    below = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    return above, below


def _h2_fancy_cols(cs: torch.Tensor, bits: int, bias_even: int, bias_odd: int) -> torch.Tensor:
    """Horizontal x2 triangular upsample of column sums [..., W] ->
    [..., 2W]: even (3*this + prev + bias_even) >> bits, odd
    (3*this + next + bias_odd) >> bits; libjpeg's edge cases by
    replication. h2v1 uses biases (1, 2), h2v2 (8, 7)."""
    left, right = _shift_cols(cs)
    even = (3 * cs + left + bias_even) >> bits
    odd = (3 * cs + right + bias_odd) >> bits
    return torch.stack([even, odd], dim=-1).reshape(*cs.shape[:-1], cs.shape[-1] * 2)


def upsample_h2v1_fancy(plane: torch.Tensor) -> torch.Tensor:
    """h2v1_fancy_upsample: [..., H, W] -> [..., H, 2W]."""
    return _h2_fancy_cols(plane.to(torch.int32), 2, 1, 2).to(torch.uint8)


def upsample_h2v2_fancy(plane: torch.Tensor) -> torch.Tensor:
    """h2v2_fancy_upsample: [..., H, W] -> [..., 2H, 2W]. Output row 2r
    blends input row r (x3) with r-1, row 2r+1 with r+1."""
    p = plane.to(torch.int32)
    above, below = _shift_rows(p)
    out_even = _h2_fancy_cols(3 * p + above, 4, 8, 7)
    out_odd = _h2_fancy_cols(3 * p + below, 4, 8, 7)
    h, w2 = out_even.shape[-2:]
    out = torch.stack([out_even, out_odd], dim=-2)
    return out.reshape(*p.shape[:-2], 2 * h, w2).to(torch.uint8)


def upsample_h1v2_fancy(plane: torch.Tensor) -> torch.Tensor:
    """h1v2_fancy_upsample (the 4:4:0 case): [..., H, W] -> [..., 2H, W];
    biases 1 (row above) and 2 (row below)."""
    p = plane.to(torch.int32)
    above, below = _shift_rows(p)
    even = (3 * p + above + 1) >> 2
    odd = (3 * p + below + 2) >> 2
    out = torch.stack([even, odd], dim=-2)
    return out.reshape(*p.shape[:-2], 2 * p.shape[-2], p.shape[-1]).to(plane.dtype)


def upsample_int(plane: torch.Tensor, h_expand: int, v_expand: int) -> torch.Tensor:
    """int_upsample: pixel replication for ratios without a fancy path."""
    out = torch.repeat_interleave(plane, v_expand, dim=-2)
    return torch.repeat_interleave(out, h_expand, dim=-1)


def upsample_component(
    plane: torch.Tensor, h_expand: int, v_expand: int, fancy: bool = True
) -> torch.Tensor:
    """jdsample.c master selection: fullsize, h2v1, h1v2, h2v2 fancy,
    else integer replication."""
    if h_expand == 1 and v_expand == 1:
        return plane
    if fancy and (h_expand, v_expand) == (2, 1):
        return upsample_h2v1_fancy(plane)
    if fancy and (h_expand, v_expand) == (1, 2):
        return upsample_h1v2_fancy(plane)
    if fancy and (h_expand, v_expand) == (2, 2):
        return upsample_h2v2_fancy(plane)
    return upsample_int(plane, h_expand, v_expand)


# ---------------------------------------------------------------------------
# Color conversion (jdcolor.c semantics)
# ---------------------------------------------------------------------------

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


FIX_R_CR = _fix(1.40200)
FIX_B_CB = _fix(1.77200)
FIX_G_CB = -_fix(0.34414)
FIX_G_CR = -_fix(0.71414)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """JFIF YCbCr -> RGB with libjpeg's 16-bit fixed point. Returns
    uint8[..., 3]."""
    yi = y.to(torch.int32)
    cbi = cb.to(torch.int32) - 128
    cri = cr.to(torch.int32) - 128
    r = yi + ((FIX_R_CR * cri + ONE_HALF) >> SCALEBITS)
    b = yi + ((FIX_B_CB * cbi + ONE_HALF) >> SCALEBITS)
    g = yi + ((FIX_G_CB * cbi + FIX_G_CR * cri + ONE_HALF) >> SCALEBITS)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Whole-frame transform
# ---------------------------------------------------------------------------


def finish_color(planes: Sequence[torch.Tensor], color: str) -> torch.Tensor:
    """Final color interpretation of full-resolution planes, as PIL
    emits each ``bitstream.color_space`` value: gray -> [..., H, W];
    ycbcr -> RGB; rgb -> passthrough; cmyk -> inverted planes; ycck ->
    ycc_to_rgb on ch0-2 plus inverted K."""
    if color == "gray":
        return planes[0]
    if color == "ycbcr":
        return ycc_to_rgb(planes[0], planes[1], planes[2])
    if color == "rgb":
        return torch.stack(list(planes), dim=-1)
    if color == "cmyk":
        return (255 - torch.stack(list(planes), dim=-1).to(torch.int32)).to(torch.uint8)
    if color == "ycck":
        rgb = ycc_to_rgb(planes[0], planes[1], planes[2])
        k = (255 - planes[3].to(torch.int32)).to(torch.uint8)
        return torch.cat([rgb, k[..., None]], dim=-1)
    raise ValueError(f"unknown color space {color!r}")


def default_color(n_components: int) -> str:
    """Marker-blind color guess by component count."""
    return {1: "gray", 3: "ycbcr", 4: "cmyk"}[n_components]


def transform_frame(
    frame,
    coeffs: Sequence[torch.Tensor],
    qtabs_zz: Sequence[torch.Tensor],
    fancy_upsampling: bool = True,
    color: Optional[str] = None,
    idct: str = "islow",
) -> torch.Tensor:
    """coeffs[ci]: int32[padded_hb*padded_wb, 64] zigzag coefficients;
    qtabs_zz[ci]: int32[64]. `idct` "float" takes ``idct8x8_float`` (the
    benchmark's control). Returns uint8[H, W, 3] (or [H, W] gray,
    [H, W, 4] CMYK/YCCK)."""
    if color is None:
        color = default_color(frame.n_components)
    planes: List[torch.Tensor] = []
    for ci, c in enumerate(frame.components):
        deq = dequantize(coeffs[ci], qtabs_zz[ci])
        samples = idct8x8_islow(deq) if idct == "islow" else idct8x8_float(deq)
        plane = blocks_to_plane(samples, c.padded_hb, c.padded_wb)
        # Crop MCU padding before upsampling: libjpeg's fancy filters
        # replicate the true edge, not the padded one.
        plane = plane[: c.dheight, : c.dwidth]
        up = upsample_component(
            plane, frame.hmax // c.h, frame.vmax // c.v, fancy=fancy_upsampling
        )
        planes.append(up[: frame.height, : frame.width])
    return finish_color(planes, color)
