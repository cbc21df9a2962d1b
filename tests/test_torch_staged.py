"""The staged coefficient path on device="cpu" against the reference:
kernel 2's plain version (coefficients, per-lane error bits, failure
classes) against the Pallas wavefront's coefficient emit in interpret
mode, decode_multiscan_to_device, pipeline.transform_batch against the
reference's kernel pipeline, and tpujpeg_torch.decode against
tpujpeg.decode and PIL on the streams the fused path does not take.
Tolerance 0. Failures are compared by image index and exception class
name (the port's exception classes are distinct objects)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from corpus import make_jpeg, make_multiscan_jpeg, make_synth_jpeg, pil_decode
from test_color import make_cmyk_jpeg
from test_torch_wavefront import MIXED_INTERVALS, MIXED_QUANTIZERS, _batch, _fuzz_batch
from test_wavefront_pallas import FUSED_CASES

import tpujpeg
from tpujpeg import bitstream as ref_bitstream
from tpujpeg.config import DecodeConfig as RefDecodeConfig
from tpujpeg.kernels import pipeline as ref_pipeline
from tpujpeg.kernels import wavefront_pallas as wp

import tpujpeg_torch
from tpujpeg_torch import DecodeConfig, bitstream, huffman
from tpujpeg_torch.kernels import pipeline
from tpujpeg_torch.kernels import wavefront as pw
from tpujpeg_torch.native import entropy as native


def _names(failures):
    return {i: type(e).__name__ for i, e in failures.items()}


def _reference_coeffs(jpegs):
    """Per image, per component coefficients, and the per-lane error bits,
    from the reference's run_wavefront(emit="coeff") + assemble."""
    plan = wp.build_block_plan(jpegs, emit_hint="coeff")
    out, err = wp.run_wavefront(
        jnp.asarray(plan.bits), jnp.asarray(plan.lane_m), jnp.asarray(plan.seg_bits),
        plan.static_key("coeff"), plan.n_groups, True,
    )
    geoms = tuple(wp.ImageGeom.of(j) for j in jpegs)
    comps = wp.assemble((plan.blocks_per_mcu, plan.n_mcus, plan.n_groups), out, geoms)
    errs = np.asarray(err).reshape(-1)[: plan.n_lanes]
    return [[np.asarray(c) for c in img] for img in comps], errs, plan


def _assert_same_coeffs(datas, mutate=None):
    ref = [ref_bitstream.parse(d) for d in datas]
    port = [bitstream.parse(d) for d in datas]
    if mutate:
        mutate(ref)
        mutate(port)
    want, want_err, ref_plan = _reference_coeffs(ref)
    want_fail = wp.failures_from_err(want_err, ref_plan.lane_meta)

    plan = pw.build_block_plan(port)
    coeffs, err = pw.decode_lanes_to_coeffs(plan, [pw.ImageGeom.of(j) for j in port], "cpu")
    np.testing.assert_array_equal(err.numpy(), want_err)
    got, fail = tpujpeg_torch.decode_batch_to_device(port, strict=False, device="cpu")
    assert _names(fail) == _names(want_fail)
    for i in range(len(datas)):
        if i in want_fail:
            assert got[i] is None
            continue
        assert len(got[i]) == len(want[i])
        for ci, (a, b) in enumerate(zip(got[i], want[i])):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"image {i} component {ci}")
            np.testing.assert_array_equal(coeffs[ci][i].numpy(), b)
    return want_fail


@pytest.mark.parametrize("case", [1, 2, 3, 4], ids=["444", "422", "gray", "odd420"])
def test_coeff_kernel_plain_matches_reference(case):
    kw = dict(FUSED_CASES[case])
    w, h = kw.pop("w"), kw.pop("h")
    assert not _assert_same_coeffs([make_jpeg(w, h, seed=9, **kw)])


def _zero_last_scan(jpegs):
    jpegs[-1].scans[0].data = bytes(len(jpegs[-1].scans[0].data))


def test_coeff_kernel_errors_and_mixed_batch_match_reference():
    """One batch: the mixed restart intervals and quantizers of the
    reference's fused tests, and last a member whose scan is zeroed."""
    datas = _batch(MIXED_INTERVALS + MIXED_QUANTIZERS[1:]) + [
        make_jpeg(120, 88, seed=0, subsampling=2, restart_blocks=4)]
    fail = _assert_same_coeffs(datas, _zero_last_scan)
    assert set(fail) == {len(datas) - 1}


def test_coeff_kernel_fuzz_errors_match_reference():
    """Seeded corruptions of one stream's scan data (test_fuzz): error
    bits per lane, failure classes, and the surviving members."""
    fail = _assert_same_coeffs(_fuzz_batch())
    assert fail


def test_coeff_path_takes_more_than_max_qsets():
    """The quantizer-set limit is the fused entry's only: nine qualities
    share one coefficient launch, as in the reference's coefficient
    entry."""
    datas = [make_jpeg(32, 32, seed=1, quality=q, restart_blocks=2) for q in range(60, 69)]
    assert len({bytes(bitstream.parse(d).qtables[0]) for d in datas}) > pw.MAX_QSETS
    assert not _assert_same_coeffs(datas)


def test_decode_multiscan_matches_reference():
    data = make_multiscan_jpeg(96, 80, seed=9, subsampling=2, restart_blocks=4)
    want = wp.decode_multiscan_to_device(ref_bitstream.parse(data))
    got = pw.decode_multiscan_to_device(bitstream.parse(data), device="cpu")
    assert len(got) == len(want) == 3
    for ci, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"component {ci}")


def test_decode_all_scans_out_of_slice_raises():
    """A small progressive stream without restarts is one lane per scan
    (kernels 7-9's plain versions here) and gives the python oracle's
    coefficients; a progressive scan over 2040 bytes without restarts
    raises with the reference's wording; a marker-free baseline stream
    takes the norst plan (kernel 2's plain version) and gives the
    oracle's coefficients."""
    data = make_jpeg(32, 32, seed=1, progressive=True)
    prog = bitstream.parse(data)
    got = pw.decode_all_scans(prog, device="cpu")
    for a, b in zip(got, huffman.decode_all_scans(bitstream.parse(data))):
        np.testing.assert_array_equal(a.numpy(), b)
    big = bitstream.parse(make_jpeg(256, 256, seed=5, progressive=True, subsampling=2))
    with pytest.raises(tpujpeg_torch.JpegUnsupportedError,
                       match="progressive scan without restart segmentation"):
        pw.decode_all_scans(big, device="cpu")
    data = make_jpeg(96, 64, seed=9, subsampling=0)
    got = pw.decode_all_scans(bitstream.parse(data), device="cpu")
    for a, b in zip(got, huffman.decode_all_scans(bitstream.parse(data))):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("variant", ["plain_qtabs", "per_image_qtabs", "dc_column"])
def test_transform_batch_matches_reference(variant):
    datas = [make_jpeg(40, 24, seed=s, quality=q, subsampling=2) for s, q in ((1, 85), (2, 60))]
    jpegs = [bitstream.parse(d) for d in datas]
    frame = ref_bitstream.parse(datas[0]).frame
    comps = [native.decode_all_scans(j) for j in jpegs]
    coeffs = [np.stack([c[ci] for c in comps]) for ci in range(3)]
    if variant == "plain_qtabs":
        qtabs = [jpegs[0].qtables[c.tq] for c in jpegs[0].frame.components]
    else:
        qtabs = [np.stack([j.qtables[c.tq] for j in jpegs]) for c in jpegs[0].frame.components]
    dcs = None
    if variant == "dc_column":
        r = np.random.default_rng(3)
        dcs = [r.integers(-600, 600, size=c.shape[:2]).astype(np.int32) for c in coeffs]
    want = ref_pipeline.transform_batch(
        frame, [jnp.asarray(c) for c in coeffs], [jnp.asarray(q) for q in qtabs], RefDecodeConfig(),
        dcs=None if dcs is None else [jnp.asarray(d) for d in dcs])
    got = pipeline.transform_batch(
        jpegs[0].frame, [torch.from_numpy(c) for c in coeffs], [torch.from_numpy(q) for q in qtabs],
        DecodeConfig(), dcs=None if dcs is None else [torch.from_numpy(d) for d in dcs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # With one table for both, only image 0 is decoded with its own.
    for i in {"plain_qtabs": [0], "per_image_qtabs": [0, 1]}.get(variant, []):
        np.testing.assert_array_equal(got[i].numpy(), pil_decode(datas[i]))


def test_transform_batch_matmul_close_to_reference():
    """idct='matmul' through the whole batch transform: float32 products
    summed in another order may round a sample the other way before the
    color stage, so |diff| <= 3 after color conversion, and at least
    99% of values equal."""
    datas = [make_jpeg(40, 24, seed=s, subsampling=2) for s in (1, 2)]
    jpegs = [bitstream.parse(d) for d in datas]
    frame = ref_bitstream.parse(datas[0]).frame
    comps = [native.decode_all_scans(j) for j in jpegs]
    coeffs = [np.stack([c[ci] for c in comps]) for ci in range(3)]
    qtabs = [jpegs[0].qtables[c.tq] for c in jpegs[0].frame.components]
    want = np.asarray(ref_pipeline.transform_batch(
        frame, [jnp.asarray(c) for c in coeffs], [jnp.asarray(q) for q in qtabs],
        RefDecodeConfig(idct="matmul"))).astype(np.int32)
    got = pipeline.transform_batch(
        jpegs[0].frame, [torch.from_numpy(c) for c in coeffs], [torch.from_numpy(q) for q in qtabs],
        DecodeConfig(idct="matmul")).numpy().astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 3
    assert (diff == 0).mean() >= 0.99


def test_batch_coeffs_through_transform_equal_fused_path():
    """The staged batch path, decode_batch_to_coeffs then transform_batch,
    gives the fused path's RGB and PIL's; decode_batch_to_device's
    per-image tensors are views of the same arrays."""
    data = make_jpeg(40, 24, seed=5, subsampling=2, restart_blocks=2)
    jpegs = [bitstream.parse(data) for _ in range(3)]
    coeffs, failures = tpujpeg_torch.decode_batch_to_coeffs(jpegs, device="cpu")
    assert not failures and [tuple(c.shape[:1]) for c in coeffs] == [(3,)] * 3
    qtabs = [torch.from_numpy(jpegs[0].qtables[c.tq]) for c in jpegs[0].frame.components]
    rgb = pipeline.transform_batch(jpegs[0].frame, coeffs, qtabs, DecodeConfig())
    fused, _ = tpujpeg_torch.decode_batch_to_rgb(jpegs, device="cpu")
    assert torch.equal(rgb, fused)
    np.testing.assert_array_equal(rgb[2].numpy(), pil_decode(data))
    per_image, _ = tpujpeg_torch.decode_batch_to_device(jpegs, device="cpu")
    for i, img in enumerate(per_image):
        for ci, c in enumerate(img):
            assert torch.equal(c, coeffs[ci][i])


STAGED = {
    "prog420": lambda: make_jpeg(64, 48, seed=1, subsampling=2, progressive=True),
    "prog444": lambda: make_jpeg(48, 40, seed=2, subsampling=0, progressive=True),
    "prog_gray": lambda: make_jpeg(48, 40, seed=3, mode="L", progressive=True),
    "marker_free420": lambda: make_jpeg(128, 96, seed=9, subsampling=2),
    "multi_scan": lambda: make_multiscan_jpeg(96, 80, seed=9, subsampling=2, restart_blocks=4),
    "synth440": lambda: make_synth_jpeg(48, 40, seed=4),
    "cmyk": lambda: make_cmyk_jpeg(),
}


@pytest.mark.parametrize("name", list(STAGED))
def test_decode_staged_matches_reference_and_pil(name):
    """Under "auto" every stream here takes the staged path but the
    marker-free single scans of the color stage's layouts (4:2:0 and
    CMYK), which the fused path takes on the norst plan."""
    data = STAGED[name]()
    got, stats = tpujpeg_torch.decode(data, device="cpu", return_stats=True)
    engine = "wavefront-fused-norst" if name in ("marker_free420", "cmyk") else "native"
    assert stats.entropy_engine == engine and stats.transform_engine == "torch"
    np.testing.assert_array_equal(got, np.asarray(tpujpeg.decode(data)))
    np.testing.assert_array_equal(got, pil_decode(data))


ENGINES = [
    ("prog420", "python", "auto"),
    ("prog444", "native", "torch"),
    ("marker_free420", "python", "auto"),
    ("multi_scan", "wavefront", "auto"),
    ("multi_scan", "python", "auto"),
    ("multi_scan", "native", "torch"),
    ("cmyk", "python", "auto"),
]


@pytest.mark.parametrize("name,entropy,transform", ENGINES,
                         ids=[f"{n}-{e}-{t}" for n, e, t in ENGINES])
def test_decode_staged_engines_match_pil(name, entropy, transform):
    data = STAGED[name]()
    config = DecodeConfig(entropy_engine=entropy, transform_engine=transform)
    got, stats = tpujpeg_torch.decode(data, config, device="cpu", return_stats=True)
    assert stats.entropy_engine == entropy
    assert stats.transform_engine == "torch"
    np.testing.assert_array_equal(got, pil_decode(data))


def test_decode_wavefront_engine_on_progressive_raises():
    """The wavefront engine takes a small progressive stream through
    kernels 7-9 (their plain versions here) and matches PIL; a scan over
    2040 bytes without restarts raises, as the reference's does."""
    data = STAGED["prog420"]()
    got, stats = tpujpeg_torch.decode(data, DecodeConfig(entropy_engine="wavefront"), device="cpu",
                                      return_stats=True)
    assert stats.entropy_engine == "wavefront"
    np.testing.assert_array_equal(got, pil_decode(data))
    big = make_jpeg(256, 256, seed=5, progressive=True, subsampling=2)
    with pytest.raises(tpujpeg_torch.JpegUnsupportedError,
                       match="progressive scan without restart segmentation"):
        tpujpeg_torch.decode(big, DecodeConfig(entropy_engine="wavefront"), device="cpu")


def test_decode_file(tmp_path):
    path = tmp_path / "prog.jpg"
    data = STAGED["prog420"]()
    path.write_bytes(data)
    np.testing.assert_array_equal(tpujpeg_torch.decode_file(str(path), device="cpu"), pil_decode(data))
