"""The whole slice on device="cpu": tpujpeg_torch.decode_batch_to_rgb and
tpujpeg_torch.decode against the reference entry points (interpret mode)
and PIL, on the reference tests' fused-path corpus, and decode() on the
streams the fused path turns away (the staged path). Tolerance 0;
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


# The three streams the fused path turns away now decode on the staged
# path (native entropy, kernel 6, kernel B); with entropy_engine=
# "wavefront" they stay outside the device paths and raise, naming the
# slice that will take them. (A progressive stream is outside them only
# when a scan without restart markers exceeds the 2040-byte row, as
# here; smaller ones run through kernels 7-9.)
OUT_OF_SLICE = {
    "progressive": (make_jpeg(256, 256, seed=5, subsampling=2, progressive=True), "marker-free"),
    "oversize_segment": (make_jpeg(96, 64, seed=9, subsampling=0), "marker-free"),
    "multi_scan": (make_multiscan_jpeg(96, 80, seed=9, subsampling=2), "marker-free"),
}


@pytest.mark.parametrize("name", list(OUT_OF_SLICE))
def test_decode_formerly_out_of_slice_matches_reference_and_pil(name):
    data, _ = OUT_OF_SLICE[name]
    got, stats = tpujpeg_torch.decode(data, device="cpu", return_stats=True)
    assert stats.entropy_engine == "native"
    np.testing.assert_array_equal(got, np.asarray(tpujpeg.decode(data)))
    np.testing.assert_array_equal(got, pil_decode(data))


@pytest.mark.parametrize("name", list(OUT_OF_SLICE))
def test_decode_out_of_slice_raises_unsupported(name):
    data, slice_word = OUT_OF_SLICE[name]
    with pytest.raises(tpujpeg_torch.JpegUnsupportedError, match=slice_word):
        tpujpeg_torch.decode(data, DecodeConfig(entropy_engine="wavefront"), device="cpu")
