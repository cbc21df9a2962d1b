"""tpujpeg_torch: the tpujpeg JPEG decoder in PyTorch with hand-written
CUDA kernels for Hopper (sm_90a).

A port of the JAX/Pallas package ``tpujpeg``, which stays beside it as
the reference: the same bytes out for the same JPEG in. This package
imports torch and never JAX; the parser, error taxonomy and native
destuff are the reference's own JAX-free files, loaded by ``host``.

Public API:
    decode(data, config, device)                -> one image
    decode_batch_to_rgb(jpegs, config, device)  -> (uint8 [N, H, W, 3], failures)
    DecodeConfig, JpegError and its subclasses

The kernels build with nvcc at first use on a CUDA device; on the CPU
every kernel's plain torch version runs instead.
"""

from .decoder import decode
from .host import (
    DEFAULT_CONFIG,
    DecodeConfig,
    DecodeStats,
    JpegError,
    JpegHuffmanError,
    JpegSyntaxError,
    JpegTruncatedError,
    JpegUnsupportedError,
    bitstream,
)
from .kernels.wavefront import decode_batch_to_rgb

__all__ = [
    "decode",
    "decode_batch_to_rgb",
    "bitstream",
    "DecodeConfig",
    "DEFAULT_CONFIG",
    "DecodeStats",
    "JpegError",
    "JpegSyntaxError",
    "JpegUnsupportedError",
    "JpegTruncatedError",
    "JpegHuffmanError",
]
