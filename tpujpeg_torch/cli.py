"""Command line: decode one JPEG to an image file with stage
timings, print a stream's structure, time repeated decodes, or decode
many files with manifest-based resume.

Port of ``tpujpeg/cli.py``: the same subcommands, flags and printed
JSON, but ``--transform`` takes the port's engines (auto, cuda, torch),
``--device`` (default cuda) names the device the decode runs on, and
``--profile DIR`` writes a ``torch.profiler`` Chrome trace. The trace holds
the port's own spans (``tpujpeg_torch.spans``: ``tpujpeg_torch.decode``
and, under it, ``parse``, ``plan``, ``copy_in`` and ``card_wait``) beside
torch's host and device events. A stream's prep threads are not in a
profile: in a program of your own, ``tpujpeg_torch.spans.drain()`` after a
profiled ``decode_stream`` returns their ``parse`` and ``plan`` records
too, each with its chunk index and its start and end on the epoch clock.

Usage:
    python -m tpujpeg_torch.cli decode in.jpg out.png [--entropy ...] [--profile DIR]
    python -m tpujpeg_torch.cli info in.jpg
    python -m tpujpeg_torch.cli bench in.jpg [--repeats N]
    python -m tpujpeg_torch.cli batch a.jpg b.jpg ... --out DIR [--on-device]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import bitstream
from .config import DecodeConfig
from .decoder import decode

ENTROPY = ["auto", "python", "native", "wavefront"]
TRANSFORM = ["auto", "cuda", "torch"]


def _write_output(path: str, arr: np.ndarray) -> None:
    if path.endswith(".ppm") or path.endswith(".pgm"):
        # PPM/PGM written here, so the CLI works without PIL.
        with open(path, "wb") as f:
            magic = b"P5" if arr.ndim == 2 else b"P6"
            f.write(magic + b"\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            f.write(arr.tobytes())
        return
    if path.endswith(".npy"):
        np.save(path, arr)
        return
    from PIL import Image

    if arr.ndim == 3 and arr.shape[-1] == 4:
        # Adobe CMYK/YCCK output (PIL's 'CMYK' convention); PNG and the
        # like cannot hold CMYK, so this needs a .jpg/.tif/.npy target.
        Image.fromarray(arr, mode="CMYK").save(path)
        return
    Image.fromarray(arr).save(path)


def _cfg_from_args(args) -> DecodeConfig:
    return DecodeConfig(
        entropy_engine=args.entropy,
        transform_engine=args.transform,
        fancy_upsampling=not args.no_fancy,
    )


def _engine_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--entropy", default="auto", choices=ENTROPY)
    p.add_argument("--transform", default="auto", choices=TRANSFORM)
    p.add_argument("--no-fancy", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device of the decode (default: cuda)")


def _profiled_decode(data: bytes, cfg: DecodeConfig, device: str, trace_dir: str):
    """decode() under torch.profiler; the Chrome trace goes to
    trace_dir/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = decode(data, cfg, device=device, return_stats=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpujpeg_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pd = sub.add_parser("decode", help="decode a JPEG to an image file")
    pd.add_argument("input")
    pd.add_argument("output")
    _engine_flags(pd)
    pd.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the decode to DIR")

    pi = sub.add_parser("info", help="print parsed stream structure")
    pi.add_argument("input")

    pb = sub.add_parser("bench", help="timed repeated decode")
    pb.add_argument("input")
    pb.add_argument("--repeats", type=int, default=5)
    _engine_flags(pb)

    pba = sub.add_parser("batch", help="decode many JPEGs to .npy with manifest-based resume")
    pba.add_argument("inputs", nargs="+")
    pba.add_argument("--out", required=True, metavar="DIR")
    pba.add_argument("--manifest", default=None)
    pba.add_argument("--chunk", type=int, default=64)
    pba.add_argument("--on-device", action="store_true",
                     help="the stream: host prep overlapped with the device decode")
    _engine_flags(pba)

    args = p.parse_args(argv)

    if args.cmd == "batch":
        from .parallel import manifest as manifest_lib

        counters = manifest_lib.run_batch_job(
            args.inputs,
            args.out,
            manifest_path=args.manifest,
            config=_cfg_from_args(args),
            chunk_size=args.chunk,
            on_device=args.on_device,
            device=args.device,
        )
        print(json.dumps(counters))
        return 0 if counters["failed"] == 0 else 2

    if args.cmd == "info":
        with open(args.input, "rb") as f:
            j = bitstream.parse(f.read())
        fr = j.frame
        info = {
            "width": fr.width,
            "height": fr.height,
            "progressive": fr.progressive,
            "components": [
                {"id": c.cid, "h": c.h, "v": c.v, "qtable": c.tq}
                for c in fr.components
            ],
            "mcus": [fr.mcus_x, fr.mcus_y],
            "color_space": bitstream.color_space(j),
            "scans": len(j.scans),
            "restart_interval": j.restart_interval,
            "segments": sum(len(s.rst_offsets) + 1 for s in j.scans),
        }
        print(json.dumps(info, indent=2))
        return 0

    with open(args.input, "rb") as f:
        data = f.read()
    cfg = _cfg_from_args(args)

    if args.cmd == "decode":
        if args.profile:
            arr, stats = _profiled_decode(data, cfg, args.device, args.profile)
        else:
            arr, stats = decode(data, cfg, device=args.device, return_stats=True)
        _write_output(args.output, arr)
        mp = stats.megapixels
        total = stats.t_parse + stats.t_entropy + stats.t_transform
        print(
            f"{stats.width}x{stats.height} "
            f"({'progressive' if stats.progressive else 'baseline'}, "
            f"{stats.n_scans} scan(s), {stats.n_segments} segment(s)) "
            f"entropy[{stats.entropy_engine}]={stats.t_entropy*1e3:.2f}ms "
            f"transform[{stats.transform_engine}]={stats.t_transform*1e3:.2f}ms "
            f"total={total*1e3:.2f}ms ({mp/total:.1f} MP/s)"
        )
        return 0

    if args.cmd == "bench":
        decode(data, cfg, device=args.device)  # warm-up: builds the kernels
        times = []
        all_stats = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            _, stats = decode(data, cfg, device=args.device, return_stats=True)
            times.append(time.perf_counter() - t0)
            all_stats.append(stats)
        best_i = int(np.argmin(times))
        best = times[best_i]
        stats = all_stats[best_i]  # engine identity of the reported run
        mp = stats.megapixels
        print(
            json.dumps(
                {
                    "megapixels": mp,
                    "best_ms": best * 1e3,
                    "mean_ms": float(np.mean(times)) * 1e3,
                    "mp_per_s": mp / best,
                    "entropy_engine": stats.entropy_engine,
                    "entropy_engines_seen": sorted(
                        {s.entropy_engine for s in all_stats}
                    ),
                }
            )
        )
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
