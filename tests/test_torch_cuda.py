"""Kernels A-D against their plain torch versions on a CUDA card.

Every test here needs a card: each skips, with a reason, where
torch.cuda.is_available() is false. This file imports neither JAX nor PIL,
so it runs on a host that has neither:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up JAX for the reference tests.)
The plain versions are held to the reference by the other
tests/test_torch_*.py files; here each kernel is held to its plain
version, on the committed fixtures and on corrupt streams, tolerance 0.
"""

import json
import os

import numpy as np
import pytest
import torch

import tpujpeg_torch
from tpujpeg_torch.kernels import build
from tpujpeg_torch.kernels import sample_color as sc
from tpujpeg_torch.kernels import wavefront as wf

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tpujpeg_torch", "fixtures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _read(name):
    with open(os.path.join(FIXTURES, MANIFEST["fixtures"][name]["file"]), "rb") as f:
        return f.read()


def _kernel_and_plain(jpegs, dev):
    plan = wf.build_block_plan(jpegs)
    geoms = [wf.ImageGeom.of(j) for j in jpegs]
    before = build.LAUNCHES["wavefront_pixels"]
    planes, err = wf.decode_lanes_to_planes(plan, geoms, dev)
    torch.cuda.synchronize()
    assert build.LAUNCHES["wavefront_pixels"] == before + 1
    want, want_err = wf.decode_lanes_to_planes(plan, geoms, dev, plain=True)
    assert build.LAUNCHES["wavefront_pixels"] == before + 1
    assert torch.equal(err, want_err)
    for a, b in zip(planes, want):
        assert torch.equal(a, b)
    return err


@pytest.mark.parametrize("name", sorted(MANIFEST["fixtures"]))
def test_kernel_a_matches_plain_on_fixtures(cuda, name):
    data = _read(name)
    err = _kernel_and_plain([tpujpeg_torch.bitstream.parse(data) for _ in range(2)], cuda)
    assert not err.any()


def test_kernel_a_matches_plain_on_corrupt_streams(cuda):
    """Seeded byte flips in the scan data of one fixture: the error bits
    and the garbage pixels of the failing lanes must match too."""
    data = _read("420_odd")
    start = data.index(b"\xff\xda")
    rng = np.random.default_rng(7)
    datas = [data]
    for _ in range(24):
        mut = bytearray(data)
        pos = int(rng.integers(start + 14, len(data) - 2))
        mut[pos] ^= int(rng.integers(1, 256))
        datas.append(bytes(mut))
    jpegs = []
    for d in datas:
        try:
            j = tpujpeg_torch.bitstream.parse(d)
            wf.build_block_plan([jpegs[0] if jpegs else j, j])
        except tpujpeg_torch.JpegError:
            continue
        jpegs.append(j)
    assert len(jpegs) > 8
    err = _kernel_and_plain(jpegs, cuda)
    assert err.any()


COLOR = [
    (sc.upsample_color_h2v2, sc.upsample_color_h2v2_plain, lambda h, w: ((h + 1) // 2, (w + 1) // 2)),
    (sc.upsample_color_h2v1, sc.upsample_color_h2v1_plain, lambda h, w: (h, (w + 1) // 2)),
    (sc.color_444, sc.color_444_plain, lambda h, w: (h, w)),
]


@pytest.mark.parametrize("k", range(3), ids=["h2v2", "h2v1", "444"])
@pytest.mark.parametrize("h,w", [(1, 1), (37, 51), (64, 48), (257, 130)])
def test_color_kernels_match_plain(cuda, k, h, w):
    kern, plain, chroma = COLOR[k]
    g = torch.Generator().manual_seed(h * 1000 + w)
    hc, wc = chroma(h, w)
    y = torch.randint(0, 256, (3, h + 3, w + 5), generator=g, dtype=torch.uint8)[:, :h, :w]
    cb, cr = (torch.randint(0, 256, (3, hc + 2, wc + 4), generator=g, dtype=torch.uint8)[:, :hc, :wc]
              for _ in range(2))
    ins = [t.to(cuda) for t in (y, cb, cr)]
    got = kern(*ins)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(*ins))
    assert torch.equal(got.cpu(), plain(y, cb, cr))


def test_decode_batch_to_rgb_on_card_matches_pil_hashes(cuda):
    import hashlib

    for name, entry in MANIFEST["fixtures"].items():
        if name == "420_2048":
            continue
        data = _read(name)
        rgb, failures = tpujpeg_torch.decode_batch_to_rgb(
            [tpujpeg_torch.bitstream.parse(data) for _ in range(3)], device=cuda)
        assert not failures and rgb.device.type == "cuda"
        for i in range(3):
            assert hashlib.sha256(rgb[i].cpu().numpy().tobytes()).hexdigest() == entry["pil_sha256"]
