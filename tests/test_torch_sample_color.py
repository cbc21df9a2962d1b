"""Plain versions of kernels B, C and D (tpujpeg_torch.kernels.sample_color)
against the reference Pallas kernels in interpret mode, on random u8
planes with odd and even sizes. The reference takes edge-padded, tile-
aligned planes and returns planar [N, 3, H', W'] output; it is cropped
and moved to NHWC here, as the reference pipeline does. Tolerance 0."""

import numpy as np
import pytest
import torch

from tpujpeg.kernels import sample_color as R

from tpujpeg_torch.kernels import sample_color as S


def _round_up(x, m):
    return -(-x // m) * m


def _pad(a, h, w):
    return np.pad(a, ((0, 0), (0, h - a.shape[1]), (0, w - a.shape[2])), mode="edge")


def _planes(seed, n, h, w, hc, wc):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, size=(n, h, w)).astype(np.uint8)
    cb, cr = (rng.integers(0, 256, size=(n, hc, wc)).astype(np.uint8) for _ in range(2))
    return y, cb, cr


def _nhwc(out, h, w):
    return np.asarray(out)[:, :, :h, :w].transpose(0, 2, 3, 1)


SHAPES = [(37, 51), (64, 48), (1, 3)]


@pytest.mark.parametrize("h,w", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_h2v2_plain_matches_reference(h, w):
    hc, wc = -(-h // 2), -(-w // 2)
    y, cb, cr = _planes(h * w, 2, h, w, hc, wc)
    ph, pw = _round_up(hc, R.ROW_TILE), _round_up(wc, 128)
    want = R.upsample_color_h2v2_batch(
        _pad(y, 2 * ph, 2 * pw), _pad(cb, ph, pw), _pad(cr, ph, pw), interpret=True
    )
    got = S.upsample_color_h2v2(*map(torch.from_numpy, (y, cb, cr)))
    np.testing.assert_array_equal(got.numpy(), _nhwc(want, h, w))


@pytest.mark.parametrize("h,w", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_h2v1_plain_matches_reference(h, w):
    wc = -(-w // 2)
    y, cb, cr = _planes(h + w, 2, h, w, h, wc)
    ph, pw = _round_up(h, R.ROW_TILE), _round_up(wc, 128)
    want = R.upsample_color_h2v1_batch(
        _pad(y, ph, 2 * pw), _pad(cb, ph, pw), _pad(cr, ph, pw), interpret=True
    )
    got = S.upsample_color_h2v1(*map(torch.from_numpy, (y, cb, cr)))
    np.testing.assert_array_equal(got.numpy(), _nhwc(want, h, w))


@pytest.mark.parametrize("h,w", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_444_plain_matches_reference(h, w):
    y, cb, cr = _planes(3 * h + w, 2, h, w, h, w)
    ph, pw = _round_up(h, R.ROW_TILE), _round_up(w, 128)
    want = R.color_444_batch(_pad(y, ph, pw), _pad(cb, ph, pw), _pad(cr, ph, pw), interpret=True)
    got = S.color_444(*map(torch.from_numpy, (y, cb, cr)))
    np.testing.assert_array_equal(got.numpy(), _nhwc(want, h, w))


def test_wrappers_take_cropped_views():
    """The pipeline hands the wrappers crops of padded planes (unit last
    stride, row stride wider than the row): same result as contiguous
    copies."""
    y, cb, cr = _planes(3, 2, 40, 48, 20, 24)
    ty, tcb, tcr = (torch.from_numpy(a) for a in (y, cb, cr))
    views = (ty[:, :39, :45], tcb[:, :20, :23], tcr[:, :20, :23])
    got = S.upsample_color_h2v2(*views)
    want = S.upsample_color_h2v2(*(v.contiguous() for v in views))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("fn,chroma", [
    (S.upsample_color_h2v2, (2, 9, 10)),
    (S.upsample_color_h2v1, (2, 19, 9)),
    (S.color_444, (2, 19, 17)),
])
def test_wrappers_reject_mismatched_chroma(fn, chroma):
    y = torch.zeros((2, 19, 19), dtype=torch.uint8)
    c = torch.zeros(chroma, dtype=torch.uint8)
    with pytest.raises(ValueError):
        fn(y, c, c)
