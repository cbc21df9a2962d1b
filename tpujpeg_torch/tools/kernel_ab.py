#!/usr/bin/env python3
"""Time the kernels of one or more checkouts on one card, in turns.

    python3 tpujpeg_torch/tools/kernel_ab.py --tree _parent --tree . --order 0,1,1,0

Each entry of --order runs one process on the tpujpeg_torch package of
--tree[i] (its kernels built there at first use) and times, on the
inputs chip_smoke.py times them on: kernels A and 2 on the plan of 32
copies of the 420_2048 fixture (mean of --reps back-to-back launches
after a warm-up), kernel 2 also on the norst plans of norst_2048 (the
default `every` and every=1: /norst_2048, /norst_2048_every1) and on the
restart plan of the 16384^2 image tile_jpeg(420_2048, 8, 8) (/giant, the
launch of chip_smoke.py's sharded phase, here without the zeroing of its
outputs; each of these three with its bound by bytes), kernel 6 on
kernel 2's coefficients, and kernels 7, 8 and 9 summed over the scans
of their kind on 32 copies of prog_rst_2048
(kernels 7 and 8, whose work does not depend on the state, as --reps
back-to-back launches; kernel 9 --reps times from the scan's own input
state). Kernel B (sample_color.upsample_color_h2v2) and the 4:2:0 planar
kernel (upsample_color_h2v2_packed) run on two inputs: kernel A's planes
of that plan, cropped to the image (/main), and random 32 x 2048^2
planes from a fixed seed (/random, the kernel_timing_ab planes of
chip_smoke.py). Kernel C (upsample_color_h2v1), the 4:2:2 planar kernel
(upsample_color_h2v1_packed) and kernel D (color_444) run on kernel A's
planes of 32 copies of their 384x512 fixture (/422, /444) and of the
2048^2 one (/422_2048, /444_2048), and on random planes of 32 x 2048^2
luma (/random). Kernel A also runs on one stream chunk of the
imagenet_shard sizes (32 images, 13 x 512^2, 10 x 768x512, 6 x 1024^2,
3 x 2048^2, made with tests/corpus.py): one launch per geometry bucket
(/shard_buckets) and one launch of its mixed form over the whole chunk
(/shard_mixed, checked equal to the bucket launches, with its CTAs per SM
and shared memory). The fixtures are read from this tool's checkout, so
every tree gets the same inputs. It uses only entry points that every
checkout since kernel A's mixed form (``wavefront.combine_plans``) has.

Kernels 7, 8 and 9 also run on one chunk of the stream_2048_prog cell's
shape (PROG_CHUNK: 32 distinct 2048^2 q85 4:2:0 progressive images with a
restart every 4 MCUs, made once with tests/corpus.py, PIL, each with its
own optimized Huffman tables), summed over the scans of their kind: each
scan as 32 one-image launches (/chunk_images, what a planner that keys
groups by the tables' bytes launches) and, where the tree's planner takes
the 32 as one group, as one launch over their table sets (/chunk, checked
equal to the one-image launches), with kernel 9's bound for the chunk by
jpegbench/roofline.py's count (payload and band bytes).

Every kernel is timed two ways in the same process. ``ms``: the card
sleeps (torch.cuda._sleep) before the start event until every launch of
the window is queued, so the window holds device time only
(``device_ms``). ``ms_wrapper``: the window opens on an idle card, so it
also holds the host's time in the Python wrapper wherever that is longer
than the kernel (the method of chip_smoke.py before the sleep, kept for
comparison with earlier figures).

Each process prints one JSON line: its tree, the ms per kernel, the
resident CTAs per SM and dynamic shared memory of kernels A and 2 at the
main plan's launch (from the library's tj_wavefront_occupancy, where the
tree has it), nvcc's
-Xptxas -v report of the build, the SASS instruction count of each
kernel in the built library (cuobjdump -sass: all instructions but NOP,
and per opcode), and a SHA-256 digest of each kernel's output (kernel
A's planes, kernel 2's coefficients, the progressive state after all
scans, each color kernel's RGB on each input). The parent process checks that
the digests of every tree agree, then prints the card's name and power
limit and one summary line (per tree, per kernel: every run's ms and
ms_wrapper and their medians; the ptxas report, parsed here or, for a library built
before the run, the tree's saved one; the SASS counts), and writes all
of it to --out. Needs a CUDA card and nvcc; exits non-zero without.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(os.path.dirname(HERE), "fixtures")
BATCH = 32


# One stream chunk of the stream_2048_prog cell's shape (2048^2, q85, 4:2:0,
# progressive, a restart every 4 MCUs): its images' seeds.
PROG_CHUNK = range(32)


def prog_chunk():
    """The bytes of PROG_CHUNK's images, from this tool's checkout's
    tests/corpus.py (PIL)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(HERE)), "tests"))
    from corpus import make_jpeg

    return [make_jpeg(2048, 2048, seed=s, quality=85, subsampling=2, progressive=True, restart_blocks=4)
            for s in PROG_CHUNK]


def kernel_9_bound_ms(datas) -> float:
    """Kernel 9's least time on every AC refinement scan of `datas`, by
    jpegbench/roofline.py's count (payload and band bytes, no changed
    sectors: a lower bound)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from jpegbench import roofline
    from jpegbench.reference import bitstream

    work = [roofline.kernel_9_work(j, k) for j in map(bitstream.parse, datas)
            for k, scan in enumerate(j.scans) if roofline.is_ac_refine(scan)]
    return roofline.bound(sum(b for b, _o in work), sum(o for _b, o in work))[0]


# One stream chunk of jpegbench/configs/imagenet_shard.json: 32 images of its
# 4:3:2:1 cycle of sizes, (width, height, images) per geometry bucket.
SHARD_CHUNK = ((512, 512, 13), (768, 512, 10), (1024, 1024, 6), (2048, 2048, 3))


def shard_chunk():
    """The bytes of SHARD_CHUNK's images per bucket, q85 4:2:0, a restart
    every 4 MCUs, from this tool's checkout's tests/corpus.py (PIL)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(HERE)), "tests"))
    from corpus import make_jpeg

    return [[make_jpeg(w, h, seed=100 * k + i, quality=85, subsampling=2, restart_blocks=4) for i in range(n)]
            for k, (w, h, n) in enumerate(SHARD_CHUNK)]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def sass_counts(lib: str, cuobjdump: str) -> dict:
    """Per kernel of the library (by mangled symbol), its SASS
    instructions but NOPs: {"instructions": n, "opcodes": {mnemonic: n}}."""
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    counts, ops = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            ops = counts.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and ops is not None and m.group(1) != "NOP":
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return {k: {"instructions": sum(v.values()), "opcodes": dict(sorted(v.items()))} for k, v in counts.items()}


_cycles_per_ms = None


def device_ms(torch, fn, reps, restore=None):
    """Mean device time of fn() over `reps` launches, with the host's work
    in the wrapper kept out of the window: before the start event the card
    sleeps until every launch of the window is queued. The launches run
    back to back in one window or, with `restore` (called before each
    launch, outside the window, e.g. to reset the state a launch
    changes), one launch per window. A window whose sleep ended before
    the host had queued its launches is run again with twice the sleep.
    fn must not synchronize."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        torch.cuda._sleep(1 << 21)
        e1.record()
        torch.cuda.synchronize()
        _cycles_per_ms = (1 << 21) / e0.elapsed_time(e1)
    if restore:
        restore()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    per_window = 1 if restore else reps
    sleep_ms = 2 * host_ms * per_window + 0.05
    total = 0.0
    for _ in range(reps // per_window):
        for _try in range(10):
            if restore:
                restore()
            torch.cuda.synchronize()
            e0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            t0 = time.perf_counter()
            e0.record()
            torch.cuda._sleep(int(sleep_ms * _cycles_per_ms))
            start.record()
            for _ in range(per_window):
                fn()
            queued_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            torch.cuda.synchronize()
            if e0.elapsed_time(start) > 1.1 * queued_ms:
                break
            sleep_ms *= 2
        else:
            raise RuntimeError(f"the card's sleep never outlasted the host's launches ({queued_ms} ms)")
        total += start.elapsed_time(end)
    return total / reps


def run_one(tree: str, reps: int, chunk_file: str) -> dict:
    """Time the kernels of `tree`'s package in this process; `chunk_file`
    holds PROG_CHUNK's images (pickled bytes)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import tpujpeg_torch
    from tpujpeg_torch.kernels import build, idct
    from tpujpeg_torch.kernels import sample_color as sc
    from tpujpeg_torch.kernels import wavefront as wf
    from tpujpeg_torch.kernels import wavefront_prog as wp
    from tpujpeg_torch.fixtures import tile

    if not os.path.abspath(tpujpeg_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {tpujpeg_torch.__file__}, not the package of {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda", 0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        build.build(verbose=True)
    build.get_lib()
    # A library built before this process left its report beside it.
    ptxas = out.getvalue() if "Compiling entry function" in out.getvalue() else None

    def parsed(name):
        with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as f:
            data = f.read()
        return [tpujpeg_torch.bitstream.parse(data) for _ in range(BATCH)]

    def wrapper_ms(fn, restore=None):
        """The window opens on an idle card: host wrapper time included."""
        fn()
        times = []
        for _ in range(reps if restore else 1):
            if restore:
                restore()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(1 if restore else reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sum(times) / reps

    ms, ms_wrapper, digests = {}, {}, {}

    def timed(name, fn, restore=None):
        t = device_ms(torch, fn, reps, restore)
        ms[name] = ms.get(name, 0.0) + t
        ms_wrapper[name] = ms_wrapper.get(name, 0.0) + wrapper_ms(fn, restore)
        return t

    jpegs = parsed("420_2048")
    plan = wf.build_block_plan(jpegs).to(dev)
    layout = wf.PlaneLayout.of(wf.ImageGeom.of(jpegs[0]))
    err = torch.zeros(plan.n_lanes, dtype=torch.int32, device=dev)
    planes = layout.alloc(BATCH, dev)
    timed("wavefront_pixels", lambda: wf._launch_wavefront(plan, layout, planes, err))
    digests["wavefront_pixels"] = _digest(planes + [err])
    coeffs = layout.alloc(BATCH, dev, "coeff")
    timed("wavefront_coeff", lambda: wf._launch_wavefront(plan, layout, coeffs, err, "coeff"))
    digests["wavefront_coeff"] = _digest(coeffs + [err])
    occupancy = {}
    occ = getattr(build.get_lib(), "tj_wavefront_occupancy", None)  # not in older trees
    if occ is not None:
        import ctypes

        occ.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        n_lut = max(wf.table_sets(plan.blk_tables)) + 1
        for kname, pixels in (("wavefront_pixels", 1), ("wavefront_coeff", 0)):
            ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
            build.raise_on_error(occ(pixels, plan.blocks_per_mcu, int(plan.qsets.shape[0]), len(layout.comp),
                                     n_lut, ctypes.addressof(ctas), ctypes.addressof(smem)), "occupancy")
            occupancy[kname] = {"ctas_per_sm": ctas.value, "smem_bytes": smem.value}

    # Kernel A on a stream chunk of the imagenet_shard sizes: one launch
    # per geometry bucket (/shard_buckets, the four summed) and one launch
    # of the mixed form over the four (/shard_mixed), held equal to the
    # bucket launches here.
    buckets = [[tpujpeg_torch.bitstream.parse(d) for d in datas] for datas in shard_chunk()]
    cplans = [wf.build_block_plan(js) for js in buckets]
    bplans = [p.to(dev) for p in cplans]
    blays = [wf.PlaneLayout.of(wf.ImageGeom.of(js[0])) for js in buckets]
    bouts = [(lay.alloc(len(js), dev), torch.zeros(p.n_lanes, dtype=torch.int32, device=dev))
             for js, p, lay in zip(buckets, bplans, blays)]

    def bucket_launches():
        for p, lay, (planes, e) in zip(bplans, blays, bouts):
            wf._launch_wavefront(p, lay, planes, e)

    timed("wavefront_pixels/shard_buckets", bucket_launches)
    digests["wavefront_pixels/shard_buckets"] = _digest([t for planes, e in bouts for t in planes + [e]])
    mixed = wf.combine_plans(cplans, blays).to(dev)
    mouts = [torch.zeros(mixed.parts[-1].end(sp), dtype=torch.uint8, device=dev)
             for sp in range(len(blays[0].comp))]
    merr = torch.zeros(mixed.n_lanes, dtype=torch.int32, device=dev)
    timed("wavefront_pixels_mixed/shard_mixed", lambda: wf._launch_wavefront(mixed, blays[0], mouts, merr))
    torch.cuda.synchronize()
    same = torch.equal(merr, torch.cat([e for _planes, e in bouts])) and all(
        torch.equal(a, b) for part, (planes, _e) in zip(mixed.parts, bouts)
        for a, b in zip(part.views(mouts), [planes[sp] for sp in part.layout.out_order]))
    if not same:
        raise RuntimeError("the mixed launch differs from the bucket launches")
    import ctypes

    ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
    build.raise_on_error(build.get_lib().tj_wavefront_occupancy_mixed(
        mixed.blocks_per_mcu, int(mixed.qsets.shape[0]), len(blays[0].comp),
        max(wf.table_sets(mixed.blk_tables)) + 1, mixed.n_images,
        ctypes.addressof(ctas), ctypes.addressof(smem)), "occupancy")
    occupancy["wavefront_pixels_mixed"] = {"ctas_per_sm": ctas.value, "smem_bytes": smem.value,
                                           "images": mixed.n_images, "lanes": mixed.n_lanes}
    del mixed, mouts, merr
    del bplans, bouts

    bound_ms = {}

    def coeff_rows(label, p, lay, n):
        """Kernel 2 alone (outputs allocated once) on plan `p`, and its
        bound by bytes as chip_smoke.py counts it: the payload read once
        and the coefficients written once, over 3.35 TB/s."""
        payload = int((p.seg_bits.to(torch.int64) - (0 if p.bit0 is None else p.bit0)).sum()) // 8
        p = p.to(dev)
        outs = lay.alloc(n, dev, "coeff")
        e = torch.zeros(p.n_lanes, dtype=torch.int32, device=dev)
        timed(f"wavefront_coeff/{label}", lambda: wf._launch_wavefront(p, lay, outs, e, "coeff"))
        digests[f"wavefront_coeff/{label}"] = _digest(outs + [e])
        bound_ms[f"wavefront_coeff/{label}"] = (payload + sum(o.numel() * 4 for o in outs)) / 3.35e12 * 1e3

    with open(os.path.join(FIXTURES, "norst_2048.jpg"), "rb") as f:
        njpeg = tpujpeg_torch.bitstream.parse(f.read())
    nlay = wf.PlaneLayout.of(wf.ImageGeom.of(njpeg))
    coeff_rows("norst_2048", wf.build_norst_plan(njpeg), nlay, 1)
    coeff_rows("norst_2048_every1", wf.build_norst_plan(njpeg, every=1), nlay, 1)
    with open(os.path.join(FIXTURES, "420_2048.jpg"), "rb") as f:
        giant = tpujpeg_torch.bitstream.parse(tile.tile_jpeg(f.read(), 8, 8))
    coeff_rows("giant", wf.build_block_plan([giant]), wf.PlaneLayout.of(wf.ImageGeom.of(giant)), 1)
    frame = jpegs[0].frame
    qtabs = [torch.from_numpy(jpegs[0].qtables[c.tq].astype("int32")).to(dev) for c in frame.components]
    timed("dequant_idct_islow", lambda: [
        idct.dequant_idct_islow(c, q, fc.padded_hb, fc.padded_wb)
        for c, q, fc in zip(coeffs, qtabs, frame.components)])
    del coeffs

    g = torch.Generator(device=dev).manual_seed(11)
    color_inputs = {
        "main": [p[:, : c.dheight, : c.dwidth] for p, c in zip(planes, frame.components)],
        "random": [torch.randint(0, 256, shape, generator=g, dtype=torch.uint8, device=dev)
                   for shape in ((BATCH, 2048, 2048), (BATCH, 1024, 1024), (BATCH, 1024, 1024))],
    }
    for label, ins in color_inputs.items():
        for kname, fn in (("upsample_color_h2v2", sc.upsample_color_h2v2),
                          ("upsample_color_h2v2_planar", sc.upsample_color_h2v2_packed)):
            timed(f"{kname}/{label}", lambda fn=fn, ins=ins: fn(*ins))
            digests[f"{kname}/{label}"] = _digest([fn(*ins)])
    del planes, color_inputs

    def a_planes(name):
        """Kernel A's planes of 32 copies of fixture `name`, cropped."""
        js = parsed(name)
        lay = wf.PlaneLayout.of(wf.ImageGeom.of(js[0]))
        out = lay.alloc(BATCH, dev)
        plan = wf.build_block_plan(js).to(dev)
        wf._launch_wavefront(plan, lay, out, torch.zeros(plan.n_lanes, dtype=torch.int32, device=dev))
        return [p[:, : c.dheight, : c.dwidth] for p, c in zip(out, js[0].frame.components)]

    g = torch.Generator(device=dev).manual_seed(12)
    for small, full, chroma_w, kernels in (
            ("422", "422_2048", 1024, (("upsample_color_h2v1", sc.upsample_color_h2v1),
                                       ("upsample_color_h2v1_planar", sc.upsample_color_h2v1_packed))),
            ("444", "444_2048", 2048, (("color_444", sc.color_444),))):
        random_ins = [torch.randint(0, 256, shape, generator=g, dtype=torch.uint8, device=dev)
                      for shape in ((BATCH, 2048, 2048), (BATCH, 2048, chroma_w), (BATCH, 2048, chroma_w))]
        for label, ins in ((small, a_planes(small)), (full, a_planes(full)), ("random", random_ins)):
            for kname, fn in kernels:
                timed(f"{kname}/{label}", lambda fn=fn, ins=ins: fn(*ins))
                digests[f"{kname}/{label}"] = _digest([fn(*ins)])
            del ins
        del random_ins

    pjpegs = parsed("prog_rst_2048")
    acs, dcs = wp.new_state(pjpegs[0].frame, BATCH, dev)
    kernel = {"dc_first": "prog_dc_first", "ac_first": "prog_ac_first", "ac_refine": "prog_ac_refine"}
    scan_ms = {}
    for k, step in enumerate(wp.plan_scans(pjpegs)):
        if isinstance(step, wp.DcRefine):
            wp.apply_step(step, acs, dcs)
            continue
        step = step.to(dev)
        target = dcs if step.kind == "dc_first" else [acs[step.comp_indices[0]]]
        before = [t.clone() for t in target]
        serr = torch.zeros(step.n_lanes, dtype=torch.int32, device=dev)
        launch = {"dc_first": lambda: wp.dc_first(step, target, serr),
                  "ac_first": lambda: wp.ac_first(step, target[0], serr),
                  "ac_refine": lambda: wp.ac_refine(step, target[0], serr)}[step.kind]

        def restore():
            for t, b in zip(target, before):
                t.copy_(b)

        # Kernels 7 and 8 do the same work from any state (7 stores, 8
        # adds), so their launches are timed back to back.
        scan_ms[f"{kernel[step.kind]}/scan{k}"] = timed(
            kernel[step.kind], launch, restore if step.kind == "ac_refine" else None)
        restore()
        launch()
        if serr.any():
            raise RuntimeError(f"{kernel[step.kind]}: error bits on a clean stream")
    digests["progressive_state"] = _digest(acs + dcs)
    del acs, dcs

    # Kernels 7-9 on PROG_CHUNK: every scan as one-image launches into
    # slices of one 32-image state (/chunk_images) and, where this tree's
    # planner groups the 32, as one launch (/chunk); kernel 9 from the
    # scan's own input state each time.
    with open(chunk_file, "rb") as f:
        cdatas = pickle.load(f)
    chunk = [tpujpeg_torch.bitstream.parse(d) for d in cdatas]
    single = [wp.plan_scans([j]) for j in chunk]
    try:
        merged = wp.plan_scans(chunk)
    except tpujpeg_torch.JpegUnsupportedError:
        merged = None  # a planner that keys groups by the tables' bytes
    states = {}
    for mode in ("chunk_images", "chunk") if merged is not None else ("chunk_images",):
        acs, dcs = wp.new_state(chunk[0].frame, len(chunk), dev)
        for k, scan in enumerate(chunk[0].scans):
            if mode == "chunk":
                parts = [(merged[k], acs, dcs)]
            else:
                parts = [(single[i][k], [a[i:i + 1] for a in acs], [d[i:i + 1] for d in dcs])
                         for i in range(len(chunk))]
            if wp.scan_kind(scan) == "dc_refine":
                for step, a, d in parts:
                    wp.apply_step(step, a, d)
                continue
            name = kernel[wp.scan_kind(scan)]
            launches, errs = [], []
            for step, a, d in parts:
                step = step.to(dev)
                e = torch.zeros(step.n_lanes, dtype=torch.int32, device=dev)
                errs.append(e)
                launches.append({"dc_first": lambda step=step, d=d, e=e: wp.dc_first(step, d, e),
                                 "ac_first": lambda step=step, a=a, e=e: wp.ac_first(
                                     step, a[step.comp_indices[0]], e),
                                 "ac_refine": lambda step=step, a=a, e=e: wp.ac_refine(
                                     step, a[step.comp_indices[0]], e)}[step.kind])
            target = dcs if scan.ss == 0 else [acs[scan.comp_indices[0]]]
            before = [t.clone() for t in target]

            def restore():
                for t, b in zip(target, before):
                    t.copy_(b)

            timed(f"{name}/{mode}", lambda: [launch() for launch in launches],
                  restore if name == "prog_ac_refine" else None)
            restore()
            for launch in launches:
                launch()
            if any(bool(e.any()) for e in errs):
                raise RuntimeError(f"{name}/{mode}: error bits on a clean stream")
        states[mode] = _digest(acs + dcs)
        del acs, dcs
    if merged is not None and states["chunk"] != states["chunk_images"]:
        raise RuntimeError("the chunk's one launch per scan differs from its one-image launches")
    digests["progressive_state/chunk_images"] = states["chunk_images"]
    bound_ms["prog_ac_refine/chunk"] = kernel_9_bound_ms(cdatas)
    occupancy["prog_chunk"] = {"images": len(chunk), "table_sets": [
        st.n_sets for st in (merged or []) if isinstance(st, wp.ScanPlan)]}
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    ms.update(scan_ms)
    return dict(tree=tree, ms=ms, ms_wrapper=ms_wrapper, digests=digests, occupancy=occupancy,
                bound_ms=bound_ms, ptxas_text=ptxas,
                ptxas_saved=None if ptxas else build.ptxas_report(),
                sass=sass_counts(build.library_path(), cuobjdump), device=torch.cuda.get_device_name(0))


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else f"nvidia-smi failed: {res.stderr}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="checkout root (repeatable); default: this one")
    ap.add_argument("--order", default=None, help="comma-separated tree indices, e.g. 0,1,1,0")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="write every line here too")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--chunk-file", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.one, args.reps, args.chunk_file)), flush=True)
        return 0

    trees = args.tree or [os.path.dirname(os.path.dirname(HERE))]
    order = [int(i) for i in args.order.split(",")] if args.order else list(range(len(trees)))
    lines, runs, failed = [], [], []
    scratch = tempfile.TemporaryDirectory()
    chunk_file = os.path.join(scratch.name, "prog_chunk.pkl")
    with open(chunk_file, "wb") as f:
        pickle.dump(prog_chunk(), f)
    for i in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", trees[i],
                              "--reps", str(args.reps), "--chunk-file", chunk_file],
                             capture_output=True, text=True)
        if res.returncode != 0:
            # Go on with the other trees; the exit code says it failed.
            print(f"{trees[i]} failed:", res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            failed.append(trees[i])
            continue
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["label"] = trees[i]
        runs.append(run)
        lines.append(json.dumps({k: v for k, v in run.items() if k not in ("ptxas_text", "ptxas_saved", "sass")}))
        print(lines[-1], flush=True)
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from tpujpeg_torch.kernels import build

    summary = {}
    for run in runs:
        s = summary.setdefault(run["label"], {"ms": {}, "ms_wrapper": {}, "ptxas": {}, "sass": {}})
        s["occupancy"], s["bound_ms"] = run["occupancy"], run["bound_ms"]
        for key in ("ms", "ms_wrapper"):
            for k, v in run[key].items():
                s[key].setdefault(k, []).append(v)
        s["ptxas"].update(build.parse_ptxas(run["ptxas_text"]) if run["ptxas_text"] else run["ptxas_saved"])
        s["sass"].update({build._entry_name(k): v for k, v in run["sass"].items()})
    for s in summary.values():
        s["median_ms"] = {k: statistics.median(v) for k, v in s["ms"].items()}
        s["median_ms_wrapper"] = {k: statistics.median(v) for k, v in s["ms_wrapper"].items()}
    agree = all(run["digests"] == runs[0]["digests"] for run in runs)
    lines += [nvidia_smi(), json.dumps({"summary": summary, "digests_agree": agree, "failed": failed})]
    print("\n".join(lines[-2:]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 1 if failed else (0 if agree else 2)


if __name__ == "__main__":
    sys.exit(main())
