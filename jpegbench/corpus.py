"""Frozen copy of the generator half of ``tests/corpus.py`` (numpy and PIL
only), so that the benchmark's traffic stays fixed while the tests change.

Synthetic JPEG corpus generator (SURVEY.md §4 integration row):
images are generated with PIL at varied quality / subsampling / restart /
progressive settings; PIL (libjpeg-turbo) is also the bit-exact oracle."""

from __future__ import annotations

import io
from typing import Optional

import numpy as np
from PIL import Image

# PIL subsampling codes.
SS_444 = 0
SS_422 = 1
SS_420 = 2


def make_image(
    w: int, h: int, seed: int = 0, mode: str = "RGB", kind: str = "photo"
) -> Image.Image:
    """Deterministic synthetic test image: smooth gradients + structured
    detail + noise, so every frequency band carries energy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 128 + 100 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
    g = 128 + 100 * np.cos(xx / 11.0 + yy / 29.0)
    b = (xx + yy) % 256
    img = np.stack([r, g, b], axis=-1)
    if kind == "photo":
        img += rng.normal(0, 12, img.shape)
    elif kind == "flat":
        img = np.full((h, w, 3), 127.0)
    elif kind == "noise":
        img = rng.uniform(0, 255, img.shape)
    arr = np.clip(img, 0, 255).astype(np.uint8)
    im = Image.fromarray(arr, "RGB")
    if mode != "RGB":
        im = im.convert(mode)
    return im


def encode(
    im: Image.Image,
    quality: int = 85,
    subsampling: int = SS_420,
    progressive: bool = False,
    restart_blocks: int = 0,
    restart_rows: int = 0,
    optimize: bool = False,
) -> bytes:
    buf = io.BytesIO()
    kw = dict(format="JPEG", quality=quality, subsampling=subsampling)
    if progressive:
        kw["progressive"] = True
    if optimize:
        kw["optimize"] = True
    if restart_blocks:
        kw["restart_marker_blocks"] = restart_blocks
    if restart_rows:
        kw["restart_marker_rows"] = restart_rows
    im.save(buf, **kw)
    return buf.getvalue()


def make_jpeg(
    w: int,
    h: int,
    seed: int = 0,
    quality: int = 85,
    subsampling: int = SS_420,
    progressive: bool = False,
    restart_blocks: int = 0,
    restart_rows: int = 0,
    mode: str = "RGB",
    kind: str = "photo",
) -> bytes:
    return encode(
        make_image(w, h, seed=seed, mode=mode, kind=kind),
        quality=quality,
        subsampling=subsampling,
        progressive=progressive,
        restart_blocks=restart_blocks,
        restart_rows=restart_rows,
    )


def pil_decode(data: bytes) -> np.ndarray:
    """Oracle decode via PIL/libjpeg-turbo (islow DCT, fancy upsampling —
    the library defaults our fixed-point path reproduces bit-exactly)."""
    im = Image.open(io.BytesIO(data))
    im.load()
    return np.asarray(im)
