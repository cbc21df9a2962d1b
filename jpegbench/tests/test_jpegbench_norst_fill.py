"""The reader of the marker-free split's counters (norst_fill_pct.upload)
on a synthetic log and trace: the sums over the window's decode() spans
only, and None where a run has no counter to read."""

import pytest

from jpegbench import spans as S
from jpegbench.tests.test_jpegbench_spans import _read, _rec, _stream_run, _upload_run

METRIC = "norst_fill_pct.upload"


def _count(name, unit, at_us, n):
    return _rec(name, unit, at_us, at_us, n=n)._replace(id=None, mirrored=False)


def test_fill_sums_lanes_over_waves_of_the_windows_decodes():
    recs = [
        _rec(S.DECODE, 5, 100.0, 1100.0), _rec(S.DECODE, 6, 3000.0, 4000.0),
        _count("norst_lanes", 5, 300.0, 64_800), _count("norst_wave", 5, 300.0, 67_584),
        _count("norst_lanes", 6, 3200.0, 32_400), _count("norst_wave", 6, 3200.0, 67_584),
        # A request of no decode span in the window (warm-up): left out.
        _count("norst_lanes", 9, 20000.0, 1), _count("norst_wave", 9, 20000.0, 67_584),
    ]
    got = _read(METRIC, _upload_run(recs))
    assert got == pytest.approx(100.0 * (64_800 + 32_400) / (2 * 67_584))


def test_no_counter_reads_none():
    plain = [_rec(S.DECODE, 5, 100.0, 1100.0), _rec(S.DECODE, 6, 3000.0, 4000.0),
             _rec(S.PLAN, 5, 200.0, 400.0)]
    assert _read(METRIC, _upload_run(plain)) is None       # a port without the counters
    assert _read(METRIC, _stream_run()) is None             # a stream cell
    untraced = _upload_run(plain)
    untraced.trace = None
    assert _read(METRIC, untraced) is None
