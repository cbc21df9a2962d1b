"""The port's batch ladder (tpujpeg_torch.parallel.batch) on device="cpu",
where the kernels' plain versions run: decode_batch_on_device and
decode_batch on a mixed list (fused, corrupted, progressive, marker-free,
not a JPEG) against PIL, with the failure classes of the reference's
tpujpeg.decode_batch_on_device on the same list; then each rung of the
fallback ladder on its own. Tolerance 0."""

import numpy as np
import pytest
import torch

from corpus import encode, make_image, make_jpeg, make_multiscan_jpeg, pil_decode
from test_torch_cuda import zero_payload

import tpujpeg

import tpujpeg_torch
from tpujpeg_torch import DecodeConfig
from tpujpeg_torch.kernels import wavefront as wf
from tpujpeg_torch.kernels import wavefront_prog as wp
from tpujpeg_torch.parallel import batch


def _corrupt(data: bytes) -> bytes:
    """40 zero bytes early in the scan payload: the image parses and plans
    with its bucket, and its lanes fail in the decode."""
    d = bytearray(data)
    sos = d.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(d[sos + 2 : sos + 4], "big")
    d[start + 10 : start + 50] = bytes(40)
    return bytes(d)


MIXED = [
    make_jpeg(128, 96, seed=1, subsampling=2, restart_blocks=8),                  # fused
    _corrupt(make_jpeg(128, 96, seed=2, subsampling=2, restart_blocks=8)),        # fused, fails
    make_jpeg(64, 48, seed=6, progressive=True, subsampling=2, restart_blocks=4),  # progressive
    make_jpeg(128, 96, seed=4, mode="L", kind="noise"),                           # marker-free, 7 KB scan
    b"not a jpeg",
]
ENGINES = {0: "wavefront-fused", 2: "wavefront-prog", 3: "wavefront-skeleton"}


def _names(errors):
    return {i: type(e).__name__ for i, e in errors.items()}


@pytest.fixture(scope="module")
def reference_errors():
    res = tpujpeg.decode_batch_on_device(MIXED)
    for i, img in enumerate(res.images):
        if img is not None:
            np.testing.assert_array_equal(np.asarray(img), pil_decode(MIXED[i]))
    return _names(res.errors)


def test_decode_batch_on_device_mixed_list_matches_pil_and_reference(reference_errors):
    res = tpujpeg_torch.decode_batch_on_device(MIXED, device="cpu")
    assert _names(res.errors) == reference_errors == {1: "JpegHuffmanError", 4: "JpegSyntaxError"}
    for i, engine in ENGINES.items():
        np.testing.assert_array_equal(res.images[i], pil_decode(MIXED[i]))
        assert res.stats[i].entropy_engine == engine and res.stats[i].transform_engine == "torch"
        assert res.stats[i].entropy_fallbacks == (engine not in ("wavefront-fused", "wavefront-prog"))
    for i in res.errors:
        assert res.images[i] is None and res.stats[i] is None


@pytest.mark.parametrize("engine", ["auto", "torch"])
def test_decode_batch_mixed_list_matches_pil_and_reference(reference_errors, engine):
    res = tpujpeg_torch.decode_batch(MIXED, DecodeConfig(transform_engine=engine), device="cpu")
    assert _names(res.errors) == reference_errors
    for i in ENGINES:
        np.testing.assert_array_equal(res.images[i], pil_decode(MIXED[i]))
        assert res.stats[i].entropy_engine == "native" and res.stats[i].transform_engine == "torch"


def test_ladder_groups_buckets_and_host_fallbacks():
    """Two progressive tables (two groups, one of two images), a
    progressive scan over 2040 bytes without restarts (outside kernels
    7-9: host entropy), a multi-scan file (kernel 2 per scan) and a 4:4:4
    bucket."""
    prog = [make_jpeg(64, 48, seed=s, progressive=True, subsampling=2, restart_blocks=4) for s in (6, 6, 7)]
    datas = prog + [
        make_jpeg(256, 256, seed=5, progressive=True, subsampling=2),
        make_multiscan_jpeg(96, 80, seed=9, subsampling=2, restart_blocks=4),
        make_jpeg(48, 32, seed=3, subsampling=0, restart_blocks=2),
    ]
    res = tpujpeg_torch.decode_batch_on_device(datas, device="cpu")
    assert not res.errors
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(img, pil_decode(d))
    assert [s.entropy_engine for s in res.stats] == ["wavefront-prog"] * 3 + ["native", "wavefront-coeff",
                                                                           "wavefront-fused"]
    assert [s.progressive for s in res.stats] == [True] * 4 + [False] * 2


def test_bucket_over_max_qsets_takes_kernel_2():
    """Nine quantizer sets in one bucket: the fused entry refuses them, so
    the bucket takes kernel 2 and a transform per quantizer set."""
    datas = [make_jpeg(32, 32, seed=1, quality=50 + q, subsampling=2, restart_blocks=2) for q in range(9)]
    datas.append(_corrupt(datas[0]))
    res = tpujpeg_torch.decode_batch_on_device(datas, device="cpu")
    assert set(res.errors) == {9}
    for d, img, st in zip(datas[:9], res.images, res.stats):
        np.testing.assert_array_equal(img, pil_decode(d))
        assert st.entropy_engine == "wavefront-coeff"


def test_to_numpy_false_returns_tensors_on_the_device():
    cfg = DecodeConfig(to_numpy=False)
    for fn in (tpujpeg_torch.decode_batch_on_device, tpujpeg_torch.decode_batch):
        res = fn(MIXED[:1] + MIXED[2:4], cfg, device="cpu")
        assert not res.errors
        for img, d in zip(res.images, MIXED[:1] + MIXED[2:4]):
            assert isinstance(img, torch.Tensor) and img.device.type == "cpu"
            np.testing.assert_array_equal(img.numpy(), pil_decode(d))


def test_bucket_key_separates_color_spaces():
    from corpus import make_image
    import io

    buf = io.BytesIO()
    make_image(32, 32, seed=1).save(buf, "JPEG", quality=90, keep_rgb=True)
    rgb = tpujpeg_torch.bitstream.parse(buf.getvalue())
    ycc = tpujpeg_torch.bitstream.parse(make_jpeg(32, 32, seed=1, subsampling=0))
    assert batch._bucket_key(rgb)[:3] == batch._bucket_key(ycc)[:3]
    assert batch._bucket_key(rgb) != batch._bucket_key(ycc)


def test_rejected_bucket_splits_and_keeps_its_members_on_the_device():
    """One 128x96 4:2:0 bucket the shared plan rejects: two images with
    restarts and the standard tables, one with restarts and optimized
    (other) tables, a marker-free stream and a multi-scan file. The
    first three stay on kernel A (two launches, one per table set), the
    marker-free one takes kernel A on its norst plan, and the multi-scan
    file kernel 2 per scan."""
    datas = [
        make_jpeg(128, 96, seed=1, subsampling=2, restart_blocks=8),
        make_jpeg(128, 96, seed=7, subsampling=2),
        encode(make_image(128, 96, seed=3), subsampling=2, restart_blocks=8, optimize=True),
        make_multiscan_jpeg(128, 96, seed=9, subsampling=2, restart_blocks=4),
        make_jpeg(128, 96, seed=2, subsampling=2, restart_blocks=8),
    ]
    res = tpujpeg_torch.decode_batch_on_device(datas, device="cpu")
    assert not res.errors
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(img, pil_decode(d))
    assert [s.entropy_engine for s in res.stats] == [
        "wavefront-fused", "wavefront-skeleton", "wavefront-fused", "wavefront-coeff", "wavefront-fused"]


def test_ladder_decodes_mixed_geometry_in_launch_groups(monkeypatch):
    """Baseline images of four geometry buckets: the three 4:2:0 buckets
    share one call of the RGB entry (one kernel-A launch on a card), the
    4:2:2 bucket takes its own; a corrupt member of the shared launch fails
    alone, and every other image equals PIL."""
    seen = []
    real = wf.decode_group_to_rgb

    def spy(plan, bucket_jpegs, *a, **k):
        seen.append([len(js) for js in bucket_jpegs])
        return real(plan, bucket_jpegs, *a, **k)

    monkeypatch.setattr(wf, "decode_group_to_rgb", spy)
    datas = [make_jpeg(64, 48, seed=1, subsampling=2, restart_blocks=4),
             make_jpeg(48, 32, seed=2, subsampling=2, restart_blocks=4),
             zero_payload(make_jpeg(64, 48, seed=3, subsampling=2, restart_blocks=4)),
             make_jpeg(48, 32, seed=4, subsampling=1, restart_blocks=4),
             make_jpeg(32, 64, seed=5, subsampling=2, restart_blocks=4)]
    res = tpujpeg_torch.decode_batch_on_device(datas, device="cpu")
    assert seen == [[2, 1, 1], [1]]
    assert set(res.errors) == {2} and isinstance(res.errors[2], tpujpeg_torch.JpegError)
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(res.images[i], pil_decode(datas[i]))
        assert res.stats[i].entropy_engine == "wavefront-fused"


def test_plan_key_admits_what_the_planner_takes_alone():
    """plan_key raises exactly where build_block_plan refuses the image on
    its own, and two images share a key iff they share Huffman tables."""
    datas = [
        make_jpeg(128, 96, seed=1, subsampling=2, restart_blocks=8),
        make_jpeg(128, 96, seed=2, subsampling=2, restart_blocks=8),
        encode(make_image(128, 96, seed=3), subsampling=2, restart_blocks=8, optimize=True),
        make_jpeg(128, 96, seed=7, subsampling=2),
        make_multiscan_jpeg(128, 96, seed=9, subsampling=2, restart_blocks=4),
        make_jpeg(64, 48, seed=6, progressive=True, subsampling=2, restart_blocks=4),
    ]
    jpegs = [tpujpeg_torch.bitstream.parse(d) for d in datas]
    keys = []
    for j in jpegs:
        try:
            wf.build_block_plan([j])
            alone = None
        except tpujpeg_torch.JpegError as e:
            alone = type(e)
        try:
            keys.append(wf.plan_key(j))
            assert alone is None
        except tpujpeg_torch.JpegError as e:
            keys.append(None)
            assert type(e) is alone
    assert keys[0] == keys[1] != keys[2] and keys[3:] == [None] * 3


_FAIL_SITES = {
    "fused": (make_jpeg(64, 48, seed=1, subsampling=2, restart_blocks=4), wf, "decode_lanes_plain"),
    "multiscan": (make_multiscan_jpeg(64, 48, seed=9, subsampling=2, restart_blocks=4), wf,
                  "decode_lanes_plain"),
    "progressive": (make_jpeg(64, 48, seed=6, progressive=True, subsampling=2, restart_blocks=4), wp,
                    "dc_first_plain"),
}


@pytest.mark.parametrize("site", sorted(_FAIL_SITES))
def test_kernel_failure_raises_and_never_moves_to_the_host(site, monkeypatch):
    """A RuntimeError where a kernel runs (here its plain version, which the
    CPU runs in its place) is no member's fault: decode_batch_on_device,
    and the stream whose fallback calls it, raise it instead of sending
    the image to host entropy or reporting it as a corrupt JPEG."""
    data, module, name = _FAIL_SITES[site]
    good = make_jpeg(32, 32, seed=4, subsampling=0, restart_blocks=2)

    def fail(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(module, name, fail)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tpujpeg_torch.decode_batch_on_device([data], device="cpu")
    for datas in ([data], [data, good]):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            list(tpujpeg_torch.decode_stream(datas, device="cpu"))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tpujpeg_torch.decode_batch([data], DecodeConfig(entropy_engine="wavefront"), device="cpu")
