"""Resumable batch job: decode jobs are short and stateless, so resume
granularity is the file, and a killed job skips the files it completed
when it restarts.

Port of ``tpujpeg/parallel/manifest.py``: the same JSONL records,
digests and output names; the decode runs on `device`. The manifest is
an append-only log, one record per file with its output path and
content digest. Each append is one short write, so a crash mid-batch
loses at most the record in flight."""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import DEFAULT_CONFIG, DecodeConfig


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def load_manifest(path: str) -> Dict[str, str]:
    """input digest -> output path for completed entries."""
    done: Dict[str, str] = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail record from a crash
                if rec.get("status") == "ok":
                    done[rec["digest"]] = rec["output"]
    return done


def run_batch_job(
    inputs: Sequence[str],
    output_dir: str,
    manifest_path: Optional[str] = None,
    config: DecodeConfig = DEFAULT_CONFIG,
    chunk_size: int = 64,
    on_device: bool = False,
    device="cuda",
) -> Dict[str, int]:
    """Decode `inputs` (JPEG file paths) on `device` into .npy rasters
    under `output_dir`, resuming from the manifest. Returns counters.
    `on_device` takes the stream (``decode_batch_pipelined``: host prep
    overlapped with the device decode), else ``decode_batch``."""
    from .batch import decode_batch
    from .stream import decode_batch_pipelined

    os.makedirs(output_dir, exist_ok=True)
    if manifest_path is None:
        manifest_path = os.path.join(output_dir, "manifest.jsonl")
    done = load_manifest(manifest_path)

    counters = {"completed": 0, "skipped": 0, "failed": 0}
    pending: List[tuple] = []  # (path, digest, bytes)
    for path in inputs:
        with open(path, "rb") as f:
            data = f.read()
        dg = _digest(data)
        if dg in done:
            counters["skipped"] += 1
            continue
        pending.append((path, dg, data))

    with open(manifest_path, "a") as mf:
        for lo in range(0, len(pending), chunk_size):
            chunk = pending[lo : lo + chunk_size]
            datas = [c[2] for c in chunk]
            if on_device:
                res = decode_batch_pipelined(datas, config, chunk_size=min(chunk_size, 64), device=device)
            else:
                res = decode_batch(datas, config, device=device)
            for slot, (path, dg, _) in enumerate(chunk):
                if slot in res.errors:
                    counters["failed"] += 1
                    rec = {"status": "error", "digest": dg, "input": path,
                           "error": str(res.errors[slot]), "ts": time.time()}
                else:
                    out_path = os.path.join(
                        output_dir, os.path.splitext(os.path.basename(path))[0] + f".{dg[:8]}.npy")
                    img = res.images[slot]
                    np.save(out_path, img.cpu().numpy() if hasattr(img, "cpu") else np.asarray(img))
                    counters["completed"] += 1
                    rec = {"status": "ok", "digest": dg, "input": path, "output": out_path,
                           "ts": time.time()}
                mf.write(json.dumps(rec) + "\n")
                mf.flush()
    return counters
