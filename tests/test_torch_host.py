"""The port's own host front end (tpujpeg_torch.bitstream, huffman and
native/) against the reference's files it was copied from, and the
port's independence from tpujpeg/: it loads no file there and writes
none there. Tolerance 0."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from corpus import make_jpeg, make_multiscan_jpeg
from test_color import make_cmyk_jpeg
from test_wavefront_pallas import FUSED_CASES

from tpujpeg import bitstream as ref_bitstream
from tpujpeg import huffman as ref_huffman
from tpujpeg.native import entropy as ref_native

from tpujpeg_torch import bitstream, huffman
from tpujpeg_torch.native import build as native_build
from tpujpeg_torch.native import entropy as native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(ROOT, "tpujpeg")


def _fused(i):
    kw = dict(FUSED_CASES[i])
    w, h = kw.pop("w"), kw.pop("h")
    return make_jpeg(w, h, seed=9, **kw)


STREAMS = {
    **{f"fused{i}": (lambda i=i: _fused(i)) for i in range(len(FUSED_CASES))},
    "progressive": lambda: make_jpeg(64, 48, seed=1, subsampling=2, progressive=True),
    "marker_free": lambda: make_jpeg(96, 64, seed=9, subsampling=2),
    "multi_scan": lambda: make_multiscan_jpeg(96, 80, seed=9, subsampling=2, restart_blocks=4),
    "cmyk": lambda: make_cmyk_jpeg(),
}


def _assert_same(a, b, where):
    """Field-by-field equality of the two parsers' outputs (their classes
    are distinct objects with the same fields)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)
    elif isinstance(a, (bytes, bytearray, memoryview)):
        assert bytes(a) == bytes(b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("name", list(STREAMS))
def test_parse_matches_reference(name):
    data = STREAMS[name]()
    port, ref = bitstream.parse(data), ref_bitstream.parse(data)
    _assert_same(port, ref, name)
    assert bitstream.color_space(port) == ref_bitstream.color_space(ref)
    assert all(len(s.rst_offsets) == len(r.rst_offsets) for s, r in zip(port.scans, ref.scans))


@pytest.mark.parametrize("name", list(STREAMS))
def test_native_decode_all_scans_matches_reference(name):
    data = STREAMS[name]()
    got = native.decode_all_scans(bitstream.parse(data))
    want = ref_native.decode_all_scans(ref_bitstream.parse(data))
    assert len(got) == len(want)
    for ci, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f"component {ci}")


@pytest.mark.parametrize("name", ["fused0", "progressive", "multi_scan"])
def test_python_oracle_matches_reference(name):
    data = STREAMS[name]()
    got = huffman.decode_all_scans(bitstream.parse(data))
    want = ref_huffman.decode_all_scans(ref_bitstream.parse(data))
    for ci, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"component {ci}")


def test_native_library_builds_into_the_port():
    so = native_build._so_path()
    assert os.path.dirname(so) == os.path.join(ROOT, "tpujpeg_torch", "_build")
    assert native_build.build() == so and os.path.exists(so)


# Runs in a fresh interpreter: records every file the process opens,
# loads, renames or builds under tpujpeg/ (an audit hook), then imports
# the port, decodes on the staged path (native entropy, kernel 6's and
# kernel B's plain versions), the fused path (the native row packer) and
# through the parallel/ modules (the stream, whose fallback runs the batch
# ladder; a tiled image through the sharded decode on two CPU shards), and
# reports what was loaded.
_PROBE = r"""
import json, os, sys
root, ref, path = sys.argv[1:4]
touched = []

def _paths(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _paths(a)
        elif isinstance(a, (str, bytes, os.PathLike)):
            yield os.path.abspath(os.fsdecode(a))

def hook(event, args):
    if event in ("open", "ctypes.dlopen", "os.rename", "os.remove", "os.mkdir",
                 "subprocess.Popen", "os.listdir", "os.scandir"):
        touched.extend((event, p) for p in _paths(args) if p == ref or p.startswith(ref + os.sep))

sys.addaudithook(hook)
sys.path.insert(0, root)
import tpujpeg_torch
data = open(path, "rb").read()
img, stats = tpujpeg_torch.decode(data, device="cpu", return_stats=True)
rgb, failures = tpujpeg_torch.decode_batch_to_rgb(
    [tpujpeg_torch.bitstream.parse(open(path + ".rst", "rb").read())], device="cpu")
from tpujpeg_torch.parallel import batch, stream, halo, mesh, manifest
from tpujpeg_torch import cli
from tpujpeg_torch.fixtures import tile
res = stream.decode_batch_pipelined([data, open(path + ".rst", "rb").read()], chunk_size=1, device="cpu")
failures = {**failures, **res.errors}
sharded = halo.decode_sharded(tile.tile_jpeg(open(path + ".rst", "rb").read(), 2, 1), mesh=("cpu",) * 2)
if sharded.shape != (48, 128, 3):
    failures["sharded"] = sharded.shape
names = ("jax", "jaxlib", "tpujpeg")
loaded = sorted(m for m in sys.modules if m in names or m.startswith(tuple(n + "." for n in names))
                or m.endswith("._shared") or "._shared." in m)
files = sorted(m.__file__ for m in list(sys.modules.values())
               if isinstance(getattr(m, "__file__", None), str)
               and os.path.abspath(m.__file__).startswith(ref + os.sep))
print(json.dumps(dict(loaded=loaded, files=files, touched=touched, shape=list(img.shape),
                      entropy=stats.entropy_engine, fused_failures=len(failures))))
"""


def test_port_reads_and_writes_nothing_of_the_reference(tmp_path):
    path = tmp_path / "staged.jpg"
    path.write_bytes(make_jpeg(64, 48, seed=1, subsampling=2, progressive=True))
    (tmp_path / "staged.jpg.rst").write_bytes(make_jpeg(64, 48, seed=2, restart_blocks=2))
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, ROOT, REF_DIR, str(path)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
    )
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["shape"] == [48, 64, 3] and report["entropy"] == "native"
    assert report["fused_failures"] == 0
    assert report["loaded"] == []
    assert report["files"] == []
    assert report["touched"] == []
