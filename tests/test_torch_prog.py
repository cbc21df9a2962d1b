"""Kernels 7, 8 and 9 (the progressive scan kernels) on device="cpu",
through their plain versions, against the reference's interpret-mode
Pallas scan kernels, scan by scan.

Both packages apply each scan of a stream to the same state with their
own ``apply_scan_batch``; after every scan the AC states, the DC columns
and the per-lane error bits are equal. The port's planner gives the
reference's lanes (rows, lengths, MCU ranges). Tolerance 0: integer
arithmetic. The error cases and the entries are in
test_torch_prog_entries.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from corpus import make_jpeg
from test_prog_device import CASES

from tpujpeg import bitstream as ref_bitstream
from tpujpeg.kernels import wavefront_prog as ref_prog

from tpujpeg_torch import bitstream
from tpujpeg_torch.kernels import wavefront_prog as prog


def ref_state(frame, n):
    nbs = [c.padded_hb * c.padded_wb for c in frame.components]
    return ([[jnp.zeros((nb, 64), jnp.int32) for nb in nbs] for _ in range(n)],
            [[jnp.zeros((nb,), jnp.int32) for nb in nbs] for _ in range(n)])


def assert_same_state(ref_acs, ref_dcs, acs, dcs, msg=""):
    for i, (ra, rd) in enumerate(zip(ref_acs, ref_dcs)):
        for ci in range(len(acs)):
            np.testing.assert_array_equal(acs[ci][i].numpy(), np.asarray(ra[ci]),
                                          err_msg=f"{msg} image {i} component {ci} AC")
            np.testing.assert_array_equal(dcs[ci][i].numpy(), np.asarray(rd[ci]),
                                          err_msg=f"{msg} image {i} component {ci} DC")


def apply_both(datas, mutate=None, check_lanes=False):
    """Every scan of a group of streams through both packages' apply_scan_batch,
    comparing after each scan. Returns (kinds seen, per kernel scan the
    port's error bits)."""
    ref = [ref_bitstream.parse(d) for d in datas]
    port = [bitstream.parse(d) for d in datas]
    if mutate:
        mutate(ref)
        mutate(port)
    ref_acs, ref_dcs = ref_state(ref[0].frame, len(datas))
    acs, dcs = prog.new_state(port[0].frame, len(datas), "cpu")
    kinds, errs = [], []
    for k, scan in enumerate(port[0].scans):
        kind = prog.scan_kind(scan)
        kinds.append(kind)
        ref_plan = None if kind == "dc_refine" else ref_prog.ScanPlan(ref, k)
        ref_errs = []
        ref_prog.apply_scan_batch(ref, k, ref_acs, ref_dcs, True, plan=ref_plan, errs_out=ref_errs)
        plan = None
        if ref_plan is not None:
            plan = prog.build_scan_plan(port, k)
            if check_lanes:
                same = prog.scan_plan_from_reference(ref_plan, port, k)
                for f in ("bits", "seg_bits", "lane_meta"):
                    assert torch.equal(getattr(plan, f), getattr(same, f)), (k, f)
                assert plan.n_mcus == same.n_mcus
        res = prog.apply_scan_batch(port, k, acs, dcs, plan=plan)
        assert (res is None) == (ref_plan is None)
        if ref_plan is not None:
            want = np.asarray(ref_errs[0][0]).reshape(-1)[: ref_plan.n_lanes]
            got = res[0].numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"scan {k} ({kind}) error bits")
            errs.append(got)
        assert_same_state(ref_acs, ref_dcs, acs, dcs, f"after scan {k} ({kind})")
    return kinds, errs


@pytest.mark.parametrize("case", [0, 1, 3, 4], ids=["420", "444", "gray", "odd420"])
def test_scan_kernels_plain_match_reference(case):
    """Each of the four CASES of test_prog_device that this file takes,
    all four scan kinds present in each stream."""
    kw = dict(CASES[case])
    w, h = kw.pop("w"), kw.pop("h")
    kinds, errs = apply_both([make_jpeg(w, h, seed=13, progressive=True, **kw)], check_lanes=True)
    assert set(kinds) == {"dc_first", "dc_refine", "ac_first", "ac_refine"}, kinds
    assert not any(e.any() for e in errs)


def _fixture(name):
    import json
    import os

    fx = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tpujpeg_torch", "fixtures")
    with open(os.path.join(fx, "manifest.json")) as f:
        entry = json.load(f)["fixtures"][name]
    with open(os.path.join(fx, entry["file"]), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["prog_gray", "prog_444"])
def test_scan_plan_luts_equal_lookahead_table(name):
    """Each kernel scan's plan carries, per scan component, the 9-bit
    lookahead of that component's Huffman table (DC for a DC first scan,
    AC otherwise), as wavefront.lookahead_table builds it: one table set,
    that of the one image."""
    from tpujpeg_torch.kernels import wavefront as wf

    port = [bitstream.parse(_fixture(name))]
    n = 0
    for k, scan in enumerate(port[0].scans):
        kind = prog.scan_kind(scan)
        if kind == "dc_refine":
            continue
        plan = prog.build_scan_plan(port, k)
        assert plan.luts.dtype == torch.int16 and tuple(plan.luts.shape) == (1, scan.n_comps, 512)
        for sp in range(scan.n_comps):
            key = (0, scan.dc_ids[sp]) if kind == "dc_first" else (1, scan.ac_ids[sp])
            want = wf.lookahead_table(wf.CanonTable.from_spec(scan.huff[key]))
            assert torch.equal(plan.luts[0, sp].to(torch.int32), want), (k, sp)
            n += 1
    assert n >= 4


@pytest.mark.parametrize("name", ["prog_gray", "prog_444"])
def test_scan_plan_from_reference_equals_build_scan_plan(name):
    """The reference's host planner (no kernel compiled) through
    scan_plan_from_reference gives the port's plan field for field,
    lookahead tables included."""
    import dataclasses

    data = _fixture(name)
    ref, port = [ref_bitstream.parse(data)], [bitstream.parse(data)]
    for k, scan in enumerate(port[0].scans):
        if prog.scan_kind(scan) == "dc_refine":
            continue
        plan = prog.build_scan_plan(port, k)
        same = prog.scan_plan_from_reference(ref_prog.ScanPlan(ref, k), port, k)
        for f in dataclasses.fields(plan):
            a, b = getattr(plan, f.name), getattr(same, f.name)
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), (k, f.name)
            else:
                assert a == b, (k, f.name)
