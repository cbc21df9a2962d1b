#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpujpeg_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this checkout (the committed fixtures in
tpujpeg_torch/fixtures/ and the reference's JAX-free host files); it
imports neither JAX nor PIL. Phases, one JSON line each:

1. device: the card's name and power limit.
2. build: nvcc builds the four kernels into tpujpeg_torch/_build/.
3. kernel_vs_plain: on every fixture at batch 2, kernel A's planes and
   error bits, and kernel B/C/D's RGB, equal their plain torch versions
   run on the same CUDA tensors (tolerance 0: integer arithmetic).
4. main_path: decode_batch_to_rgb of 32 copies of the 2048x2048 q85
   4:2:0 fixture (restart every 4 MCUs), one warm-up and 3 timed runs;
   the launch counters, zeroed just before, show kernels A and B ran
   and no other. Then one batch of 32 each of the 4:2:2, 4:4:4 and gray
   fixtures through the same entry, each counted apart: A and C, A and
   D, A alone. Decoded images hash to PIL's (manifest). Then each
   kernel and its plain version are timed with CUDA events on the main
   path's inputs and compared.
5. faults: one corrupted member of a batch fails with the manifest's
   exception class; the other members stay bit-exact.
6. decode: tpujpeg_torch.decode of a fixture hashes to PIL's.

Then the nvidia-smi line, the kernels JSON line and, last, the ok line.
Exits non-zero, printing no ok line, on any failure or without a card.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tpujpeg_torch", "fixtures")
MAIN_BATCH = 32

# name -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "wavefront_pixels": ("tpujpeg_torch/csrc/wavefront.cu", "tpujpeg/kernels/wavefront_pallas.py:660"),
    "upsample_color_h2v2": ("tpujpeg_torch/csrc/sample_color.cu", "tpujpeg/kernels/sample_color.py:97"),
    "upsample_color_h2v1": ("tpujpeg_torch/csrc/sample_color.cu", "tpujpeg/kernels/sample_color.py:146"),
    "color_444": ("tpujpeg_torch/csrc/sample_color.cu", "tpujpeg/kernels/sample_color.py:160"),
}


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def sha(a) -> str:
    return hashlib.sha256(a.contiguous().cpu().numpy().tobytes()).hexdigest()


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(torch, a, b) -> int:
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item()) if a.numel() else 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import tpujpeg_torch
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repo: {e}", file=sys.stderr)
        return 1
    from tpujpeg_torch.kernels import build, sample_color as sc, wavefront as wf

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    datas = {}
    for name, entry in manifest["fixtures"].items():
        with open(os.path.join(FIXTURES, entry["file"]), "rb") as f:
            datas[name] = f.read()
        check(hashlib.sha256(datas[name]).hexdigest() == entry["file_sha256"], f"{name}: file hash")
    dev = torch.device("cuda", 0)
    parse = tpujpeg_torch.bitstream.parse

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. build
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.get_lib()
    emit("build", seconds=time.perf_counter() - t0, library=os.path.relpath(build.library_path(), HERE))

    color_fns = {
        "upsample_color_h2v2": (sc.upsample_color_h2v2, sc.upsample_color_h2v2_plain),
        "upsample_color_h2v1": (sc.upsample_color_h2v1, sc.upsample_color_h2v1_plain),
        "color_444": (sc.color_444, sc.color_444_plain),
    }
    color_of = {"420_2048": "upsample_color_h2v2", "420_odd": "upsample_color_h2v2",
                "422": "upsample_color_h2v1", "444": "color_444"}

    def lanes(plan, geoms):
        """Kernel A and its plain version on the same CUDA tensors."""
        planes_k, err_k = wf.decode_lanes_to_planes(plan, geoms, dev)
        torch.cuda.synchronize()
        planes_p, err_p = wf.decode_lanes_to_planes(plan, geoms, dev, plain=True)
        torch.cuda.synchronize()
        return planes_k, err_k, planes_p, err_p

    def cropped(frame, planes):
        return [p[:, : c.dheight, : c.dwidth] for p, c in zip(planes, frame.components)]

    # 3. kernel vs plain on every fixture at batch 2
    for name, data in datas.items():
        jpegs = [parse(data) for _ in range(2)]
        plan = wf.build_block_plan(jpegs)
        geoms = [wf.ImageGeom.of(j) for j in jpegs]
        planes_k, err_k, planes_p, err_p = lanes(plan, geoms)
        err_a = max(max_abs(torch, a, b) for a, b in zip(planes_k, planes_p))
        check(err_a == 0 and torch.equal(err_k, err_p), f"{name}: kernel A != plain ({err_a})")
        check(not err_k.any(), f"{name}: decode errors {err_k.nonzero().flatten().tolist()}")
        rec = dict(fixture=name, lanes=plan.n_lanes, words=plan.n_words, kernel_a_max_abs_err=err_a)
        if name in color_of:
            kern, plain = color_fns[color_of[name]]
            ins = cropped(jpegs[0].frame, planes_k)
            out_k = kern(*ins)
            torch.cuda.synchronize()
            out_p = plain(*ins)
            rec["color_max_abs_err"] = max_abs(torch, out_k, out_p)
            check(rec["color_max_abs_err"] == 0, f"{name}: color kernel != plain")
            check(sha(out_k[0]) == manifest["fixtures"][name]["pil_sha256"], f"{name}: RGB != PIL")
        else:
            c = jpegs[0].frame.components[0]
            gray = planes_k[0][0, : c.dheight, : c.dwidth]
            check(sha(gray) == manifest["fixtures"][name]["pil_sha256"], f"{name}: gray != PIL")
        emit("kernel_vs_plain", **rec)

    # 4. main path: the counters cover the 4:2:0 batch's four calls alone.
    data = datas["420_2048"]
    t0 = time.perf_counter()
    jpegs = [parse(data) for _ in range(MAIN_BATCH)]
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = wf.build_block_plan(jpegs)
    t_plan = time.perf_counter() - t0
    walls = []
    build.LAUNCHES.clear()
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, failures = tpujpeg_torch.decode_batch_to_rgb(jpegs, device=dev)
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - t0)
        check(not failures, f"main path failures: {failures}")
    main_launches = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
    want = manifest["fixtures"]["420_2048"]
    check(list(rgb.shape) == [MAIN_BATCH] + want["shape"], f"main path shape {tuple(rgb.shape)}")
    for i in (0, MAIN_BATCH - 1):
        check(sha(rgb[i]) == want["pil_sha256"], f"main path image {i} != PIL")
    mp = MAIN_BATCH * rgb.shape[1] * rgb.shape[2] / 1e6
    wall = statistics.median(walls)
    check(set(k for k, n in main_launches.items() if n) == {"wavefront_pixels", "upsample_color_h2v2"},
          f"main path launches {main_launches}")
    emit("main_path", images=MAIN_BATCH, megapixels=mp, calls=4, wall_s=walls, wall_median_s=wall,
         mp_per_s=mp / wall, parse_s=t_parse, host_plan_s=t_plan, launches=main_launches,
         lanes=plan.n_lanes, words=plan.n_words, rgb_bytes=rgb.numel())
    del rgb

    # The same entry on the other subsamplings: kernels C and D each run
    # on their own batch, counted apart from the main path.
    launches = dict(main_launches)
    others = {}
    for name, kname in (("422", "upsample_color_h2v1"), ("444", "color_444"), ("gray", None)):
        js = [parse(datas[name]) for _ in range(MAIN_BATCH)]
        build.LAUNCHES.clear()
        out, failures = tpujpeg_torch.decode_batch_to_rgb(js, device=dev)
        torch.cuda.synchronize()
        got = {k: build.LAUNCHES.get(k, 0) for k in KERNELS}
        check(not failures, f"{name}: failures {failures}")
        for i in (0, MAIN_BATCH - 1):
            check(sha(out[i]) == manifest["fixtures"][name]["pil_sha256"], f"{name}: image {i} != PIL")
        want_k = {"wavefront_pixels"} | ({kname} if kname else set())
        check(set(k for k, n in got.items() if n) == want_k, f"{name}: launches {got}")
        if kname:
            launches[kname] = got[kname]
        others[name] = js
        emit("batch", fixture=name, images=MAIN_BATCH, launches=got)

    # Each kernel against its plain version on the main path's inputs.
    results = {}
    geoms = [wf.ImageGeom.of(j) for j in jpegs]
    planes_k, err_k, planes_p, err_p = lanes(plan, geoms)
    err_a = max(max_abs(torch, a, b) for a, b in zip(planes_k, planes_p))
    check(err_a == 0 and torch.equal(err_k, err_p), f"main path: kernel A != plain ({err_a})")
    layout = wf.PlaneLayout.of(geoms[0])
    pd = plan.to(dev)
    scratch = layout.alloc(len(geoms), dev)
    err_s = torch.zeros(plan.n_lanes, dtype=torch.int32, device=dev)
    results["wavefront_pixels"] = dict(
        max_abs_err=err_a,
        ms=cuda_ms(torch, lambda: wf._launch_wavefront(pd, layout, scratch, err_s), 5),
        plain_ms=cuda_ms(torch, lambda: wf.decode_lanes_plain(pd, layout, scratch, err_s), 1),
        shape=f"{plan.n_lanes} lanes x {plan.n_words} words, {plan.blocks_per_mcu} blocks/MCU, "
              f"{plan.n_mcus} MCUs/lane",
    )
    del planes_p, scratch
    color_inputs = {"upsample_color_h2v2": (jpegs[0].frame, planes_k)}
    for name, kname in (("422", "upsample_color_h2v1"), ("444", "color_444")):
        js = others[name]
        color_inputs[kname] = (js[0].frame, wf.decode_lanes_to_planes(
            wf.build_block_plan(js), [wf.ImageGeom.of(j) for j in js], dev)[0])
    for kname, (frame, planes) in color_inputs.items():
        kern, plain = color_fns[kname]
        ins = cropped(frame, planes)
        out_k = kern(*ins)
        out_p = plain(*ins)
        results[kname] = dict(
            max_abs_err=max_abs(torch, out_k, out_p),
            ms=cuda_ms(torch, lambda: kern(*ins), 10),
            plain_ms=cuda_ms(torch, lambda: plain(*ins), 3),
            shape=f"{tuple(ins[0].shape)} luma, {tuple(ins[1].shape)} chroma -> {tuple(out_k.shape)}",
        )
        check(results[kname]["max_abs_err"] == 0, f"{kname}: kernel != plain on the main path")
        del out_k, out_p
    for k, r in results.items():
        emit("kernel_timing", kernel=k, **r)

    # 5. faults
    for fault in manifest["faults"]:
        data = datas[fault["fixture"]]
        js = [parse(data) for _ in range(fault["batch"])]
        scan = js[fault["member"]].scans[0]
        scan.data = bytes([fault["fill"]]) * len(scan.data)
        out, failures = tpujpeg_torch.decode_batch_to_rgb(js, device=dev)
        got = {i: type(e).__name__ for i, e in failures.items()}
        check(got == {fault["member"]: fault["error"]}, f"fault {fault}: got {got}")
        for i in range(fault["batch"]):
            if i != fault["member"]:
                check(sha(out[i]) == manifest["fixtures"][fault["fixture"]]["pil_sha256"],
                      f"fault {fault}: member {i} not bit-exact")
        emit("faults", fault=fault, failures=got)

    # 6. decode()
    for name in ("420_odd", "gray"):
        out = tpujpeg_torch.decode(datas[name], device=dev)
        check(hashlib.sha256(out.tobytes()).hexdigest() == manifest["fixtures"][name]["pil_sha256"],
              f"decode({name}) != PIL")
        emit("decode", fixture=name, shape=list(out.shape))

    loaded = sorted(m for m in ("jax", "jaxlib", "PIL", "tpujpeg") if m in sys.modules)
    check(not loaded, f"the port loaded {loaded}")
    print(smi)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=KERNELS[k][0], replaces=KERNELS[k][1],
             launches=launches[k], max_abs_err=results[k]["max_abs_err"],
             ms=results[k]["ms"], plain_ms=results[k]["plain_ms"])
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
