"""The JAX-free host front end, shared with the reference package.

The parser (``bitstream``), the error taxonomy (``errors``), the config
and stats dataclasses and the native destuff (``native/``) in
``tpujpeg/`` import no JAX, but ``import tpujpeg.<anything>`` runs
``tpujpeg/__init__.py``, which does. So this module loads those files
under a private package name, ``tpujpeg_torch._shared``, whose search
path is the reference's own directory: the port runs the very same
parser, exceptions and native row packer as the reference, nothing is
copied, and ``tpujpeg/__init__.py`` never executes. The modules'
relative imports (``from .errors``, ``from .native import entropy``,
``from .. import bitstream``) resolve inside the private package.

Only the files named in ``_MODULES`` are ever imported through it.
Exception classes loaded here are distinct objects from
``tpujpeg.errors.*`` in a process that imports both packages; compare
them by class name there.
"""

from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import os
import sys

_REF_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tpujpeg"
)
_PKG = __name__.rpartition(".")[0] + "._shared"
_MODULES = ("errors", "config", "stats", "bitstream", "native.entropy")


def _load_shared():
    if _PKG not in sys.modules:
        if not os.path.isfile(os.path.join(_REF_DIR, "bitstream.py")):
            raise ImportError(f"reference host sources not found in {_REF_DIR}")
        spec = importlib.machinery.ModuleSpec(_PKG, None, is_package=True)
        spec.submodule_search_locations = [_REF_DIR]
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[_PKG] = pkg
    return [importlib.import_module(f"{_PKG}.{m}") for m in _MODULES]


errors, config, stats, bitstream, native_entropy = _load_shared()

JpegError = errors.JpegError
JpegSyntaxError = errors.JpegSyntaxError
JpegUnsupportedError = errors.JpegUnsupportedError
JpegTruncatedError = errors.JpegTruncatedError
JpegHuffmanError = errors.JpegHuffmanError
DecodeConfig = config.DecodeConfig
DEFAULT_CONFIG = config.DEFAULT_CONFIG
DecodeStats = stats.DecodeStats
