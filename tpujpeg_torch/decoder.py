"""Single-image decode: parse, then the fused path or the staged path.

Port of ``tpujpeg/decoder.py``'s routing. A non-progressive stream with
``entropy_engine`` in ('auto', 'wavefront') and ``transform_engine`` in
('auto', 'cuda') first tries the fused batch-1 path
(``decode_batch_to_rgb([jpeg])``: kernel A, then the color stage); a
data error in it (bad Huffman code, AC overrun, truncation) raises.
Where the restart planner refuses the stream (``JpegUnsupportedError``:
no restart markers, segments over the lane row) and ``entropy_engine``
is 'auto', the fused path runs on the norst plan
(``decode_norst_to_rgb``: the scan cut at skeleton-scan offsets, kernel
A, the color stage; engine "wavefront-fused-norst"), as the reference's
``_decode_fused_single`` does. 'wavefront' keeps the engine it names for
such a stream: kernel 2 on the norst plan, in the staged path. What the
fused paths refuse (several scans) falls through to the staged path:

1. entropy to zigzag coefficients: 'auto' takes the native C++ decoder
   on the host (the python oracle when the native library does not
   build, as the reference's ``auto`` does), 'native' and 'python' name
   one, 'wavefront' runs kernel 2 on `device` (on the norst plan where
   the restart planner refuses a scan; kernels 7-9 for a progressive
   frame; 'auto' keeps progressive on the host, as the
   reference's does);
2. ``kernels.pipeline.transform_frame`` on `device` (kernel 6, then the
   color kernels; their plain versions for CPU tensors), or the plain
   torch transform with ``transform_engine='torch'``.
"""

from __future__ import annotations

import itertools
import time
from typing import List

import torch

from . import bitstream, huffman, spans
from . import transform as T
from .config import DEFAULT_CONFIG, DecodeConfig
from .errors import JpegUnsupportedError
from .kernels import wavefront
from .stats import DecodeStats


def _entropy_decode(jpeg, config: DecodeConfig, stats: DecodeStats, device) -> List:
    """Per frame component, zigzag int32 [padded_blocks, 64] coefficients:
    numpy arrays from the host engines, tensors on `device` from the
    wavefront engine."""
    engine = config.entropy_engine
    if engine == "auto":
        try:
            from .native import build as native_build

            native_build.get_lib()
            engine = "native"
        except Exception:
            engine = "python"
    if engine == "native":
        from .native import entropy as native_entropy

        stats.entropy_engine = "native"
        return native_entropy.decode_all_scans(jpeg)
    if engine == "wavefront":
        stats.entropy_engine = "wavefront"
        return wavefront.decode_all_scans(jpeg, config, device)
    if engine != "python":
        raise ValueError(f"unknown entropy engine {engine!r}")
    stats.entropy_engine = "python"
    return huffman.decode_all_scans(jpeg)


def _finish(out: torch.Tensor, config: DecodeConfig, stats: DecodeStats, return_stats: bool):
    if config.to_numpy:
        out = out.cpu().numpy()
    return (out, stats) if return_stats else out


_requests = itertools.count()  # decode()'s request numbers: its traced units


def decode(data: bytes, config: DecodeConfig = DEFAULT_CONFIG, device="cuda",
           return_stats: bool = False):
    """Decode one JPEG byte string on `device` to uint8 [H, W, 3] RGB,
    [H, W] gray or [H, W, 4] CMYK: a numpy array when
    ``config.to_numpy`` (the default, as in the reference), else a
    tensor on `device`. Traced, each call is one unit of the spans
    (``spans.DECODE`` and everything under it)."""
    with spans.adopt(next(_requests) if spans.recording() else None), spans.span(spans.DECODE):
        return _decode(data, config, device, return_stats)


def _decode(data: bytes, config: DecodeConfig, device, return_stats: bool):
    device = torch.device(device)
    stats = DecodeStats()
    t0 = time.perf_counter()
    jpeg = bitstream.parse(data)
    stats.t_parse = time.perf_counter() - t0
    frame = jpeg.frame
    stats.width, stats.height = frame.width, frame.height
    stats.n_components = frame.n_components
    stats.progressive = frame.progressive
    stats.n_scans = len(jpeg.scans)
    stats.n_segments = sum(len(s.rst_offsets) + 1 for s in jpeg.scans)
    stats.restart_interval = jpeg.restart_interval
    stats.bitstream_bytes = len(data)
    stats.total_blocks = sum(c.padded_hb * c.padded_wb for c in frame.components)
    kernel_engine = "cuda" if device.type == "cuda" else "torch"

    if (
        not frame.progressive
        and config.entropy_engine in ("auto", "wavefront")
        and config.transform_engine in ("auto", "cuda")
    ):
        t0 = time.perf_counter()
        out = None
        try:
            rgb, failures = wavefront.decode_batch_to_rgb([jpeg], config, device=device)
        except JpegUnsupportedError:
            if config.entropy_engine == "auto":
                try:
                    out = wavefront.decode_norst_to_rgb(jpeg, config, device=device)
                    stats.entropy_engine = "wavefront-fused-norst"
                except JpegUnsupportedError:
                    pass
        else:
            if 0 in failures:
                raise failures[0]
            out = rgb[0]
            stats.entropy_engine = "wavefront-fused"
        if out is not None:
            stats.transform_engine = kernel_engine
            if device.type == "cuda":
                with spans.span(spans.CARD_WAIT):
                    torch.cuda.synchronize(device)
            stats.t_transform = time.perf_counter() - t0
            return _finish(out, config, stats, return_stats)
        stats.entropy_fallbacks += 1

    t0 = time.perf_counter()
    coeffs = _entropy_decode(jpeg, config, stats, device)
    with spans.span(spans.COPY_IN):
        coeffs = [torch.as_tensor(c).to(device) for c in coeffs]
        qtabs = [torch.from_numpy(jpeg.qtables[c.tq].astype("int32")).to(device)
                 for c in frame.components]
    if device.type == "cuda":
        with spans.span(spans.CARD_WAIT):
            torch.cuda.synchronize(device)
    stats.t_entropy = time.perf_counter() - t0

    t0 = time.perf_counter()
    color = bitstream.color_space(jpeg)
    engine = config.transform_engine
    if engine in ("auto", "cuda"):
        from .kernels import pipeline

        out = pipeline.transform_frame(frame, coeffs, qtabs, config, color=color)
        stats.transform_engine = kernel_engine
    elif engine == "torch":
        out = T.transform_frame(frame, coeffs, qtabs, config.fancy_upsampling, color)
        stats.transform_engine = "torch"
    else:
        raise ValueError(f"unknown transform engine {engine!r}")
    if device.type == "cuda":
        with spans.span(spans.CARD_WAIT):
            torch.cuda.synchronize(device)
    stats.t_transform = time.perf_counter() - t0
    return _finish(out, config, stats, return_stats)


def decode_file(path: str, config: DecodeConfig = DEFAULT_CONFIG, **kw):
    with open(path, "rb") as f:
        return decode(f.read(), config, **kw)
