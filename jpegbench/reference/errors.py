"""Frozen copy of ``tpujpeg_torch/errors.py`` for the benchmark's plain reference.

Error hierarchy for tpujpeg.

The reference (xinfushe/oclJPEGDecoder, empty mount — see SURVEY.md §0) is
reconstructed as using `clGetError`-style check-and-abort (SURVEY.md §5
"Failure detection"). The TPU-native build replaces that with a typed error
hierarchy so that batch decode can isolate per-image failures
(SURVEY.md §5: "a corrupt JPEG marks its slot invalid, never kills the
batch").
"""

from __future__ import annotations


class JpegError(Exception):
    """Base class for all decode errors."""


class JpegSyntaxError(JpegError):
    """Malformed bitstream structure: bad marker, bad segment length."""


class JpegUnsupportedError(JpegError):
    """Valid JPEG that uses a feature we do not decode (e.g. arithmetic
    coding, lossless SOF3, 12-bit precision)."""


class JpegTruncatedError(JpegSyntaxError):
    """Bitstream ended before decode completed."""


class JpegHuffmanError(JpegSyntaxError):
    """Invalid Huffman code or missing table during entropy decode."""
