"""The whole slice on device="cpu": tpujpeg_torch.decode_batch_to_rgb and
tpujpeg_torch.decode against the reference entry points (interpret mode)
and PIL, on the reference tests' fused-path corpus, and decode() on the
streams the restart-segment fused path turns away (the norst plan and
the staged path). Tolerance 0;
failures are compared by image index and exception class name (the
port's exception classes are distinct objects). Batches with failing
members are compared in test_torch_wavefront.py (per-lane error bits)
and test_torch_fixtures.py (failure classes and RGB)."""

import numpy as np
import pytest

from corpus import make_jpeg, make_multiscan_jpeg, pil_decode
from test_wavefront_pallas import FUSED_CASES

import tpujpeg
from tpujpeg import bitstream as ref_bitstream
from tpujpeg.kernels import wavefront_pallas as wp

import tpujpeg_torch
from tpujpeg_torch import DecodeConfig


def _data(case, seed=9):
    kw = dict(case)
    w, h = kw.pop("w"), kw.pop("h")
    return make_jpeg(w, h, seed=seed, **kw)


def _names(failures):
    return {i: type(e).__name__ for i, e in failures.items()}


@pytest.mark.parametrize("case", FUSED_CASES, ids=[str(i) for i in range(len(FUSED_CASES))])
def test_decode_batch_to_rgb_matches_reference_and_pil(case):
    data = _data(case)
    want, want_fail = wp.decode_batch_to_rgb([ref_bitstream.parse(data)])
    got, fail = tpujpeg_torch.decode_batch_to_rgb([tpujpeg_torch.bitstream.parse(data)], device="cpu")
    assert _names(fail) == _names(want_fail) == {}
    assert str(got.dtype) == "torch.uint8"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), pil_decode(data))


@pytest.mark.parametrize("case", FUSED_CASES, ids=[str(i) for i in range(len(FUSED_CASES))])
def test_decode_matches_reference(case):
    data = _data(case)
    got, stats = tpujpeg_torch.decode(data, device="cpu", return_stats=True)
    np.testing.assert_array_equal(got, np.asarray(tpujpeg.decode(data)))
    assert stats.entropy_engine == "wavefront-fused"
    assert (stats.width, stats.height) == (case["w"], case["h"])


def test_decode_returns_tensor_without_to_numpy():
    data = _data(FUSED_CASES[3])
    out = tpujpeg_torch.decode(data, DecodeConfig(to_numpy=False), device="cpu")
    assert out.device.type == "cpu" and tuple(out.shape) == (64, 96)
    np.testing.assert_array_equal(out.numpy(), pil_decode(data))


# The three streams the restart-segment fused path turns away. Under
# "auto" the marker-free one takes the fused path on the norst plan
# (kernel A over lanes cut at skeleton-scan offsets), as the reference's
# _decode_fused_single does, and the other two the staged path (native
# entropy, kernel 6, kernel B). With entropy_engine="wavefront" the
# baseline two run kernel 2 (on the norst plan where the restart planner
# refuses a scan) and equal the reference and PIL; the progressive one,
# whose scans run over 2040 bytes without restarts, raises in both
# packages with the reference's wording.
OUT_OF_SLICE = {
    "progressive": (make_jpeg(256, 256, seed=5, subsampling=2, progressive=True),
                    "progressive scan without restart segmentation"),
    "oversize_segment": (make_jpeg(96, 64, seed=9, subsampling=0), None),
    "multi_scan": (make_multiscan_jpeg(96, 80, seed=9, subsampling=2), None),
}
AUTO_ENGINE = {"oversize_segment": "wavefront-fused-norst"}


@pytest.mark.parametrize("name", list(OUT_OF_SLICE))
def test_decode_formerly_out_of_slice_matches_reference_and_pil(name):
    data, _ = OUT_OF_SLICE[name]
    got, stats = tpujpeg_torch.decode(data, device="cpu", return_stats=True)
    assert stats.entropy_engine == AUTO_ENGINE.get(name, "native")
    np.testing.assert_array_equal(got, np.asarray(tpujpeg.decode(data)))
    np.testing.assert_array_equal(got, pil_decode(data))


@pytest.mark.parametrize("name", list(OUT_OF_SLICE))
def test_decode_out_of_slice_raises_unsupported(name):
    """entropy_engine="wavefront": the progressive stream raises
    JpegUnsupportedError; the marker-free and multi-scan ones decode on
    kernel 2's plain version to the reference's image and PIL's, with
    engine "wavefront" as the reference reports."""
    data, raise_match = OUT_OF_SLICE[name]
    config = DecodeConfig(entropy_engine="wavefront")
    if raise_match is not None:
        with pytest.raises(tpujpeg_torch.JpegUnsupportedError, match=raise_match):
            tpujpeg_torch.decode(data, config, device="cpu")
        return
    got, stats = tpujpeg_torch.decode(data, config, device="cpu", return_stats=True)
    assert stats.entropy_engine == "wavefront"
    np.testing.assert_array_equal(got, np.asarray(tpujpeg.decode(data)))
    np.testing.assert_array_equal(got, pil_decode(data))
