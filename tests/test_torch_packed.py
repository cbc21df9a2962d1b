"""The packed16 layout of the port (planar RGB as uint16 [N, 3, H, W/2]
whose little-endian bytes are the planar uint8 raster) against the
reference: the planar kernels' plain versions against the reference's
Pallas color kernels with packed_words=True in interpret mode,
``transform_planes_batch(packed=True)`` against the reference's on a
corpus image, ``packed_layout_applies`` over the corpus's samplings,
color spaces and width parities, and the odd-width refusal. Tolerance 0
(integer arithmetic)."""

import numpy as np
import pytest
import torch

from corpus import make_jpeg, make_synth_jpeg, pil_decode
from test_color import make_cmyk_jpeg, make_rgb_jpeg

from tpujpeg import bitstream as ref_bitstream
from tpujpeg.config import DecodeConfig as RefDecodeConfig
from tpujpeg.kernels import pipeline as ref_pipeline
from tpujpeg.kernels import sample_color as R

from tpujpeg_torch import DecodeConfig, bitstream
from tpujpeg_torch.kernels import pipeline
from tpujpeg_torch.kernels import sample_color as S
from tpujpeg_torch.kernels import wavefront as wf


def _planes(seed, n, h, w, hc, wc):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, size=(n, h, w)).astype(np.uint8)
    cb, cr = (rng.integers(0, 256, size=(n, hc, wc)).astype(np.uint8) for _ in range(2))
    return y, cb, cr


def test_h2v2_packed_plain_matches_reference_packed_words():
    y, cb, cr = _planes(1, 2, 128, 256, 64, 128)
    want = np.asarray(R.upsample_color_h2v2_batch(y, cb, cr, interpret=True, packed_words=True))
    got = S.upsample_color_h2v2_packed_plain(*map(torch.from_numpy, (y, cb, cr)))
    assert got.dtype == torch.uint16 and want.dtype == np.uint16
    np.testing.assert_array_equal(got.numpy(), want)


def test_h2v1_packed_plain_matches_reference_packed_words():
    y, cb, cr = _planes(2, 2, 64, 256, 64, 128)
    want = np.asarray(R.upsample_color_h2v1_batch(y, cb, cr, interpret=True, packed_words=True))
    got = S.upsample_color_h2v1_packed_plain(*map(torch.from_numpy, (y, cb, cr)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", [S.upsample_color_h2v2_packed, S.upsample_color_h2v1_packed],
                         ids=["h2v2", "h2v1"])
def test_packed_wrappers_on_cpu_equal_their_plain_versions_on_crops(fn):
    """Cropped views of wider planes (row stride over the width, odd
    height) go in without a copy, as the pipeline hands them."""
    h2v2 = fn is S.upsample_color_h2v2_packed
    h, w = 37, 50
    hc = (h + 1) // 2 if h2v2 else h
    y, cb, cr = (torch.from_numpy(a) for a in _planes(3, 2, h + 3, w + 5, hc + 2, w // 2 + 3))
    views = (y[:, :h, :w], cb[:, :hc, : w // 2], cr[:, :hc, : w // 2])
    got = fn(*views)
    plain = S.upsample_color_h2v2_packed_plain if h2v2 else S.upsample_color_h2v1_packed_plain
    assert got.shape == (2, 3, h, w // 2)
    np.testing.assert_array_equal(got.numpy(), plain(*(v.contiguous() for v in views)).numpy())
    nhwc = (S.upsample_color_h2v2 if h2v2 else S.upsample_color_h2v1)(*views)
    np.testing.assert_array_equal(got.numpy().view(np.uint8).reshape(2, 3, h, w),
                                  nhwc.numpy().transpose(0, 3, 1, 2))


@pytest.mark.parametrize("fn", [S.upsample_color_h2v2_packed, S.upsample_color_h2v1_packed],
                         ids=["h2v2", "h2v1"])
def test_packed_wrappers_refuse_odd_width(fn):
    h2v2 = fn is S.upsample_color_h2v2_packed
    y = torch.zeros((1, 9, 17), dtype=torch.uint8)
    c = torch.zeros((1, 5 if h2v2 else 9, 9), dtype=torch.uint8)
    with pytest.raises(ValueError, match="even width"):
        fn(y, c, c)


def test_transform_planes_batch_packed_matches_reference():
    """A 128x96 4:2:0 corpus image: the port's sample planes through both
    packages' transform_planes_batch(packed=True)."""
    data = make_jpeg(128, 96, seed=4, subsampling=2, restart_blocks=4)
    jpegs = [bitstream.parse(data)] * 2
    planes, err = wf.decode_lanes_to_planes(wf.build_block_plan(jpegs), [wf.ImageGeom.of(j) for j in jpegs],
                                            "cpu")
    assert not err.any()
    frame = jpegs[0].frame
    got = pipeline.transform_planes_batch(frame, planes, DecodeConfig(), color="ycbcr", packed=True)
    want = ref_pipeline.transform_planes_batch(ref_bitstream.parse(data).frame, [p.numpy() for p in planes],
                                               RefDecodeConfig(), color="ycbcr", packed=True)
    assert got.dtype == torch.uint16 and got.shape == (2, 3, 96, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    planar = got[0].numpy().view(np.uint8).reshape(3, 96, 128)
    np.testing.assert_array_equal(np.moveaxis(planar, 0, 2), pil_decode(data))
    nhwc = pipeline.transform_planes_batch(frame, planes, DecodeConfig(), color="ycbcr")
    assert nhwc.shape == (2, 96, 128, 3)


LAYOUT_CORPUS = {
    **{f"ss{ss}_{w}": (lambda ss=ss, w=w: make_jpeg(w, 24, seed=ss, subsampling=ss))
       for ss in (0, 1, 2) for w in (32, 33)},
    "gray": lambda: make_jpeg(32, 24, seed=1, mode="L"),
    "cmyk": lambda: make_cmyk_jpeg(w=32, h=24),
    "rgb": lambda: make_rgb_jpeg(w=32, h=24),
    "440": lambda: make_synth_jpeg(32, 24, hv=((1, 2), (1, 1), (1, 1))),
    "411": lambda: make_synth_jpeg(32, 24, hv=((4, 1), (1, 1), (1, 1))),
}


@pytest.mark.parametrize("name", list(LAYOUT_CORPUS))
def test_packed_layout_applies_matches_reference(name):
    data = LAYOUT_CORPUS[name]()
    port, ref = bitstream.parse(data), ref_bitstream.parse(data)
    color = bitstream.color_space(port)
    assert color == ref_bitstream.color_space(ref)
    for fancy in (True, False):
        for c in {color, "ycbcr"}:
            assert pipeline.packed_layout_applies(port.frame, DecodeConfig(fancy_upsampling=fancy), c) == \
                ref_pipeline.packed_layout_applies(ref.frame, RefDecodeConfig(fancy_upsampling=fancy), c), \
                (name, fancy, c)
