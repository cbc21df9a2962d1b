"""The committed fixtures that chip_smoke.py decodes on the card, and the
port's independence from JAX and PIL.

The manifest's hashes must be PIL's decode of each file here; its fault
expectations must be what the reference decoder raises; and importing
tpujpeg_torch and decoding on the CPU must load neither jax nor PIL."""

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from corpus import pil_decode

from tpujpeg import bitstream as ref_bitstream
from tpujpeg.kernels import wavefront_pallas as wp

import tpujpeg_torch
from tpujpeg_torch.kernels import wavefront_prog as wprog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tpujpeg_torch", "fixtures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _read(name):
    with open(os.path.join(FIXTURES, MANIFEST["fixtures"][name]["file"]), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(MANIFEST["fixtures"]))
def test_manifest_hash_is_pil_decode(name):
    entry = MANIFEST["fixtures"][name]
    data = _read(name)
    assert hashlib.sha256(data).hexdigest() == entry["file_sha256"]
    img = pil_decode(data)
    assert list(img.shape) == entry["shape"]
    assert hashlib.sha256(img.tobytes()).hexdigest() == entry["pil_sha256"]


@pytest.mark.parametrize("fault", MANIFEST["faults"], ids=lambda f: f"{f['fixture']}-fill{f['fill']}")
def test_manifest_faults_are_what_the_reference_raises(fault):
    data = _read(fault["fixture"])
    ref = [ref_bitstream.parse(data) for _ in range(fault["batch"])]
    port = [tpujpeg_torch.bitstream.parse(data) for _ in range(fault["batch"])]
    for jpegs in (ref, port):
        scan = jpegs[fault["member"]].scans[0]
        scan.data = bytes([fault["fill"]]) * len(scan.data)
    want_rgb, want = wp.decode_batch_to_rgb(ref)
    got_rgb, got = tpujpeg_torch.decode_batch_to_rgb(port, device="cpu")
    expected = {fault["member"]: fault["error"]}
    assert {i: type(e).__name__ for i, e in want.items()} == expected
    assert {i: type(e).__name__ for i, e in got.items()} == expected
    np.testing.assert_array_equal(got_rgb.numpy(), np.asarray(want_rgb))


# prog_rst_2048's scan script: (kind, components, Ss, Se, Ah, Al, segments).
PROG_RST_2048_SCRIPT = [
    ("dc_first", (0, 1, 2), 0, 0, 0, 1, 4096),
    ("ac_first", (0,), 1, 5, 0, 2, 16384),
    ("ac_first", (2,), 1, 63, 0, 1, 4096),
    ("ac_first", (1,), 1, 63, 0, 1, 4096),
    ("ac_first", (0,), 6, 63, 0, 2, 16384),
    ("ac_refine", (0,), 1, 63, 2, 1, 16384),
    ("dc_refine", (0, 1, 2), 0, 0, 1, 0, 4096),
    ("ac_refine", (2,), 1, 63, 1, 0, 4096),
    ("ac_refine", (1,), 1, 63, 1, 0, 4096),
    ("ac_refine", (0,), 1, 63, 1, 0, 16384),
]


@pytest.mark.parametrize("name", sorted(n for n, e in MANIFEST["fixtures"].items()
                                        if e["path"] == "progressive"))
def test_progressive_fixtures_plan_on_the_scan_planner(name):
    """The progressive path's fixtures are restart-segmented progressive
    streams inside the scan planner's scope, with all four scan kinds;
    prog_rst_2048 has the scan script chip_smoke.py's counts rest on."""
    jpeg = tpujpeg_torch.bitstream.parse(_read(name))
    assert jpeg.frame.progressive and jpeg.restart_interval
    steps = wprog.plan_scans([jpeg])
    kinds = [wprog.scan_kind(s) for s in jpeg.scans]
    assert set(kinds) == {"dc_first", "dc_refine", "ac_first", "ac_refine"}
    if name == "prog_rst_2048":
        got = [(k, tuple(s.comp_indices), s.ss, s.se, s.ah, s.al, len(s.rst_offsets) + 1)
               for k, s in zip(kinds, jpeg.scans)]
        assert got == PROG_RST_2048_SCRIPT
        assert sum(st.n_lanes for st in steps if isinstance(st, wprog.ScanPlan)) == 90112 - 4096


def test_port_imports_neither_jax_nor_pil():
    code = (
        "import sys, hashlib, json\n"
        "import tpujpeg_torch\n"
        "m = json.load(open('tpujpeg_torch/fixtures/manifest.json'))['fixtures']['420_odd']\n"
        "out = tpujpeg_torch.decode(open('tpujpeg_torch/fixtures/' + m['file'], 'rb').read(), device='cpu')\n"
        "assert hashlib.sha256(out.tobytes()).hexdigest() == m['pil_sha256']\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'PIL', 'tpujpeg'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def _python_files():
    pkg = os.path.join(ROOT, "tpujpeg_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


# The one PIL import a port source may hold: the command line's image
# writer imports PIL inside the function, for formats other than PPM, PGM
# and NPY, as the reference's cli does; decoding never loads it (the test
# above).
LAZY_PIL = {"tpujpeg_torch/cli.py"}


def test_no_jax_or_pil_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|PIL|tpujpeg)\b", re.M)
    lazy_pil = re.compile(r"^[ \t]+(import|from)\s+PIL\b", re.M)
    offenders = []
    for path in _python_files():
        rel = os.path.relpath(path, ROOT)
        with open(path) as f:
            src = f.read()
        if rel in LAZY_PIL:
            src = lazy_pil.sub("", src)
        if pattern.search(src):
            offenders.append(rel)
    assert not offenders
