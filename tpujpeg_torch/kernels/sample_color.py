"""Fused fancy upsample + YCbCr -> RGB: wrappers for kernels B, C and D.

Port of ``tpujpeg/kernels/sample_color.py``. Each wrapper takes the
cropped component planes (uint8[N, dheight, dwidth] views; only the
last axis has to be contiguous, so a crop of the decoder's padded
planes goes in without a copy) and returns NHWC uint8 [N, H, W, 3] at
the luma plane's size, the reference's final layout without its phase
split, halos or u16 packing. On CUDA tensors each launches its kernel
in ``csrc/sample_color.cu``, one tiled design for every sampling
(``h2v2_tile_kernel`` for B and the 4:2:0 planar kernel,
``h2v1_tile_kernel`` for C and the 4:2:2 planar kernel,
``color_444_tile_kernel`` for D: 16 pixels per thread, 16-byte loads
and stores where the planes are aligned and W % 16 == 0, masked bytes
otherwise), and raises if the launch fails; on the CPU it runs its
plain version, which is built from ``transform.py``'s functions (the
jdcolor.c constants there are the reference's ``_FIX_*``/``_color_i32``).

The planar wrappers (``upsample_color_h2v2_packed``,
``upsample_color_h2v1_packed``) return the reference's packed16 layout
(``packed_words=True``): planar RGB as uint16 [N, 3, H, W/2] whose
little-endian bytes are the planar uint8 raster [N, 3, H, W]. They take
even W only. On CUDA tensors they launch the planar kernels; their plain
versions are kernels B and C's, permuted to planar and viewed as uint16.
"""

from __future__ import annotations

import torch

from .. import transform as T
from . import build


def _half(n: int) -> int:
    return (n + 1) // 2


def upsample_color_h2v2_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Kernel B's plain version: 4:2:0 fancy upsample + color."""
    h, w = y.shape[-2:]
    up = [T.upsample_h2v2_fancy(c)[..., :h, :w] for c in (cb, cr)]
    return T.ycc_to_rgb(y, *up)


def upsample_color_h2v1_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Kernel C's plain version: 4:2:2 fancy upsample + color."""
    w = y.shape[-1]
    up = [T.upsample_h2v1_fancy(c)[..., :w] for c in (cb, cr)]
    return T.ycc_to_rgb(y, *up)


def color_444_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Kernel D's plain version: color conversion only."""
    return T.ycc_to_rgb(y, cb, cr)


def _packed(nhwc: torch.Tensor) -> torch.Tensor:
    """NHWC uint8 [N, H, W, 3] -> planar uint16 [N, 3, H, W/2] with the
    same bytes as the planar raster (low byte = even column)."""
    return nhwc.permute(0, 3, 1, 2).contiguous().view(torch.uint16)


def upsample_color_h2v2_packed_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """The 4:2:0 planar kernel's plain version: kernel B's, packed."""
    return _packed(upsample_color_h2v2_plain(y, cb, cr))


def upsample_color_h2v1_packed_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """The 4:2:2 planar kernel's plain version: kernel C's, packed."""
    return _packed(upsample_color_h2v1_plain(y, cb, cr))


def _check_planes(name: str, y, cb, cr, chroma_hw) -> None:
    for i, t in enumerate((y, cb, cr)):
        if t.dtype != torch.uint8 or t.dim() != 3 or t.stride(-1) != 1:
            raise ValueError(f"{name}: plane {i} must be uint8 [N, H, W] with unit last stride, "
                             f"got {t.dtype}{tuple(t.shape)} strides {t.stride()}")
        if t.device != y.device:
            raise ValueError(f"{name}: planes on {y.device} and {t.device}")
    want = (y.shape[0],) + tuple(chroma_hw)
    if tuple(cb.shape) != want or tuple(cr.shape) != want:
        raise ValueError(f"{name}: chroma {tuple(cb.shape)}/{tuple(cr.shape)}, want {want} "
                         f"for luma {tuple(y.shape)}")


def _run(name: str, plain, y, cb, cr, extra=(), planar: bool = False) -> torch.Tensor:
    """Launch kernel `tj_<name>` for CUDA planes (raising if it fails), or
    run `plain` for CPU planes. The kernel writes NHWC uint8 [N, H, W, 3],
    or with `planar` uint8 [N, 3, H, W], returned as uint16 [N, 3, H, W/2]."""
    if y.device.type == "cpu":
        return plain(y, cb, cr)
    if y.device.type != "cuda":
        raise ValueError(f"{name}: no path for device {y.device}")
    n, h, w = y.shape
    shape = (n, 3, h, w) if planar else (n, h, w, 3)
    out = torch.empty(shape, dtype=torch.uint8, device=y.device)
    args = []
    for t in (y, cb, cr):
        args += [t.data_ptr(), t.stride(0), t.stride(1)]
    rc = build.call(y.device, "tj_" + name, *args, n, h, w, *extra, out.data_ptr())
    build.raise_on_error(rc, name)
    build.launched(name)
    return out.view(torch.uint16) if planar else out


def upsample_color_h2v2(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Kernel B: luma [N, H, W], chroma [N, ceil(H/2), ceil(W/2)] ->
    RGB [N, H, W, 3]."""
    hc, wc = _half(y.shape[1]), _half(y.shape[2])
    _check_planes("upsample_color_h2v2", y, cb, cr, (hc, wc))
    return _run("upsample_color_h2v2", upsample_color_h2v2_plain, y, cb, cr, (hc, wc))


def upsample_color_h2v1(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Kernel C: luma [N, H, W], chroma [N, H, ceil(W/2)] -> RGB."""
    hc, wc = y.shape[1], _half(y.shape[2])
    _check_planes("upsample_color_h2v1", y, cb, cr, (hc, wc))
    return _run("upsample_color_h2v1", upsample_color_h2v1_plain, y, cb, cr, (hc, wc))


def color_444(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Kernel D: three [N, H, W] planes -> RGB."""
    _check_planes("color_444", y, cb, cr, y.shape[1:])
    return _run("color_444", color_444_plain, y, cb, cr)


def _check_even(name: str, y: torch.Tensor) -> None:
    if y.shape[-1] % 2:
        raise ValueError(f"{name}: the packed16 layout needs an even width, got {y.shape[-1]}")


def upsample_color_h2v2_packed(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """4:2:0 planar kernel: luma [N, H, W] (W even), chroma [N, ceil(H/2),
    W/2] -> planar RGB uint16 [N, 3, H, W/2] (the reference's packed16)."""
    hc, wc = _half(y.shape[1]), _half(y.shape[2])
    _check_planes("upsample_color_h2v2_planar", y, cb, cr, (hc, wc))
    _check_even("upsample_color_h2v2_planar", y)
    return _run("upsample_color_h2v2_planar", upsample_color_h2v2_packed_plain, y, cb, cr, (hc, wc),
                planar=True)


def upsample_color_h2v1_packed(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """4:2:2 planar kernel: luma [N, H, W] (W even), chroma [N, H, W/2] ->
    planar RGB uint16 [N, 3, H, W/2]."""
    hc, wc = y.shape[1], _half(y.shape[2])
    _check_planes("upsample_color_h2v1_planar", y, cb, cr, (hc, wc))
    _check_even("upsample_color_h2v1_planar", y)
    return _run("upsample_color_h2v1_planar", upsample_color_h2v1_packed_plain, y, cb, cr, (hc, wc),
                planar=True)
