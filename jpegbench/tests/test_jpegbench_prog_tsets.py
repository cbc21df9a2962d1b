"""The reader of the port's ``prog_tsets`` counter
(``prog_tsets_per_launch.stream``) on a synthetic log: the table sets per
launch of kernels 7-9 over the launches of the chunks the window yielded,
fallback chunks included, and None where the port records no such count."""

import types

import pytest

from jpegbench.tests.test_jpegbench_spans import EPOCH_NS, MAIN, Rec, _read, _run, _trace

METRIC = "prog_tsets_per_launch.stream"


def _count(name, unit, n, at_us=2000.0):
    t = EPOCH_NS + int(at_us * 1000)
    return Rec(name, unit, None, None, MAIN, t, t, n, False)


def _prog_run(counts, engines=("fallback", "fallback")):
    """A stream run whose chunks launched kernels 7-9 with the given
    (unit, sets) counts; `engines` are the yielded chunks'."""
    recs = [_count("prog_tsets", unit, n) for unit, n in counts]
    recs += [_count("launch", unit, 1) for unit, _n in counts]
    trace = _trace([], device=[(2000.0, 2400.0)])
    return _run("stream_loop", recs, trace, [{"engine": e} for e in engines], order=range(6))


def test_the_mean_over_the_yielded_chunks_launches():
    # Chunks 0 and 1 yielded; chunk 2's launches were in flight at the close.
    run = _prog_run([(0, 32), (0, 32), (0, 16), (1, 32), (2, 1)])
    assert _read(METRIC, run) == pytest.approx((32 + 32 + 16 + 32) / 4)


def test_nothing_to_read_gives_none():
    assert _read(METRIC, _prog_run([])) is None                              # no progressive launch
    assert _read(METRIC, _prog_run([(2, 32)])) is None                       # none in a yielded chunk
    bare = _prog_run([(0, 32)])
    bare.port = types.SimpleNamespace()                                      # a port without spans
    untraced = _prog_run([(0, 32)])
    untraced.trace = None
    assert _read(METRIC, bare) is None and _read(METRIC, untraced) is None
