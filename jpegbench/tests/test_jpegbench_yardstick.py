"""The benchmark's frozen yardstick on the CPU: the roofline counts give
PERF.md's bounds on its shapes, the plain reference equals PIL
(libjpeg-turbo), the control (the reference in float) fails the
comparison, and a one-pixel change is judged incorrect."""

import os

import numpy as np
import pytest
import torch

from jpegbench import corpus, harness as H, roofline as R
from jpegbench.reference import bitstream, decode, huffman

FIXTURES = os.path.join(H.ROOT, "tpujpeg_torch", "fixtures")


def _fixture(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def test_kernel_a_bound_on_32_images_of_2048_420():
    jpeg = bitstream.parse(_fixture("420_2048.jpg"))
    nbytes, ops = R.kernel_a_work(jpeg)
    ms, by = R.bound(32 * nbytes, 32 * ops)
    assert by == "bytes" and round(ms, 5) == 0.07284
    # The exact symbol count moves the operations, not the bound.
    n_symbols = R.symbols(huffman.decode_all_scans(jpeg))
    assert n_symbols > R.blocks(jpeg.frame)
    ms_exact, by_exact = R.bound(*(32 * x for x in R.kernel_a_work(jpeg, n_symbols)))
    assert by_exact == "bytes" and ms_exact == ms


def test_kernel_9_bound_on_32_images_of_prog_rst_2048():
    jpeg = bitstream.parse(_fixture("prog_rst_2048.jpg"))
    coeffs = huffman.alloc_coeffs(jpeg.frame)
    exact = [0, 0]
    lower = [0, 0]
    for k, scan in enumerate(jpeg.scans):
        ci = scan.comp_indices[0]
        before = coeffs[ci].copy()
        huffman.decode_progressive_scan(jpeg, scan, coeffs)
        if R.is_ac_refine(scan):
            for acc, work in ((exact, R.kernel_9_work(jpeg, k, before, coeffs[ci])), (lower, R.kernel_9_work(jpeg, k))):
                acc[0] += 32 * work[0]
                acc[1] += 32 * work[1]
    ms, by = R.bound(*exact)
    assert by == "bytes" and round(ms, 4) == 0.6048
    assert R.bound(*lower)[0] < ms


CASES = {
    "420_rst": dict(subsampling=2, restart_blocks=4),
    "422_rst": dict(subsampling=1, restart_blocks=4),
    "444_rst": dict(subsampling=0, restart_blocks=4),
    "420_markerfree": dict(subsampling=2),
    "444_markerfree": dict(subsampling=0, quality=90),
    "420_progressive_rst": dict(subsampling=2, progressive=True, restart_blocks=4),
    "422_progressive": dict(subsampling=1, progressive=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_pil(case):
    data = corpus.make_jpeg(131, 67, seed=11, **CASES[case])
    got = decode.rgb(data, decode.coefficients(data), "cpu").numpy()
    assert np.array_equal(got, corpus.pil_decode(data))


@pytest.mark.parametrize("case", ["420_rst", "444_markerfree"])
def test_the_control_fails_the_comparison(case):
    data = corpus.make_jpeg(131, 67, seed=11, **CASES[case])
    c = decode.coefficients(data)
    exact, control = decode.rgb(data, c, "cpu"), decode.rgb(data, c, "cpu", idct="float")
    assert int((exact != control).sum()) > 0


def _judged(image, layout="nhwc", failed=0):
    run = H.Run(H.load_benchmark(), "uploads_4k_rst", seed=3, device="cpu")
    run.torch = torch
    data = corpus.make_jpeg(64, 48, seed=3, subsampling=1, restart_blocks=4)
    run.pool = [H.Item(data, 64 * 48 / 1e6, "4:2:2")]
    run.sample.kept = [(0, image(data), layout)]
    run.failed = failed
    return H.correct(run.judge(workers=1))


def _ref(data):
    return torch.from_numpy(corpus.pil_decode(data).copy())


def test_an_exact_output_is_judged_correct():
    assert _judged(_ref)


def test_a_one_pixel_change_is_judged_incorrect():
    def changed(data):
        im = _ref(data)
        im[17, 23, 1] ^= 1
        return im
    assert not _judged(changed)


def test_a_failed_request_is_judged_incorrect():
    assert not _judged(_ref, failed=1)


def test_packed16_outputs_are_read_as_their_planar_bytes():
    def packed(data):
        planar = _ref(data).permute(2, 0, 1).contiguous()
        return planar.view(torch.uint16)
    assert _judged(packed, "packed16")
