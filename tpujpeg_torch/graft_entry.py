"""Graft entry points of the port: ``entry()`` and ``dryrun_multichip(n)``.

Port of the repo's ``__graft_entry__.py``.

``entry(device)`` returns the flagship device step and its example
inputs: the transform (dequant, islow IDCT, fancy upsampling, YCbCr to
RGB) of a 512x512 baseline 4:2:0 frame, ``kernels.pipeline.
transform_frame``: kernel 6 once per component, then kernel B.

``dryrun_multichip(n)`` runs the engine's sharded paths over a mesh of n
devices (``parallel/mesh.py``: one shard per card where there are n
cards, else n shards of card 0) on small shapes, and checks each one:

1. one image's MCU rows sharded over the mesh
   (``halo.sharded_transform``), equal byte for byte to the
   single-device transform of the same coefficients on ``mesh[0]``;
1a. the same with MCU rows that do not divide among the shards;
1b. the DC-predictor prefix fixup across shards (``halo.dc_prefix_fixup``);
2. the data-parallel fused decode (``wavefront.decode_batch_to_rgb_sharded``:
   kernel A and the color stage per shard), each image hashing to PIL's;
3. the data-parallel batched transform (``batch.transform_over_mesh``:
   ``pipeline.transform_batch`` per piece of the batch), each image equal
   to the single-device transform of its coefficients.

Both take the reference's draws, in the reference's order, from the same
numpy seeds, so the two packages see the same numbers. Neither runs
without a card unless the caller names CPU devices, as the tests do. The
reference's filter of XLA:CPU loader lines on fd 2 has no counterpart:
nothing here compiles through XLA.

    python -m tpujpeg_torch.graft_entry

runs ``entry()``'s step once and ``dryrun_multichip(4)``, one line each.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bitstream
from .config import DEFAULT_CONFIG
from .kernels import pipeline
from .kernels import wavefront as wf
from .parallel import batch as batch_lib
from .parallel import halo

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
DRYRUN_FIXTURE = "420_odd"   # path 2's default image: 129x65 4:2:0, a restart every 3 MCUs
H2V2 = [(2, 2), (1, 1), (1, 1)]
ENTRY_SIZE = (512, 512)   # entry()'s frame: height, width


def make_frame(height: int, width: int, hv) -> bitstream.Frame:
    """A baseline 8-bit frame of the given size and (h, v) sampling
    factors, one quantizer table, as the reference's ``_make_frame``."""
    frame = bitstream.Frame(
        progressive=False, precision=8, height=height, width=width,
        components=[bitstream.Component(index=i, cid=i, h=h, v=v, tq=0) for i, (h, v) in enumerate(hv)],
    )
    frame.finalize()
    return frame


def _require_card(devices: Sequence[torch.device]) -> None:
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only on a card "
                           "(pass CPU devices explicitly for the plain versions)")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def entry(device="cuda") -> Tuple[Callable, Tuple]:
    """Return (fn, example_args): fn(coeffs, qtabs) is the transform of a
    512x512 4:2:0 frame (``pipeline.transform_frame``; on a card kernel 6
    three times and kernel B once) giving uint8 [512, 512, 3] on
    `device`; coeffs holds per component int32 [padded_blocks, 64] drawn
    from -64..63, qtabs per component int32 [64] drawn from 1..63, both
    on `device`. Raises RuntimeError on a CUDA device without a card."""
    device = torch.device(device)
    _require_card([device])
    frame = make_frame(*ENTRY_SIZE, H2V2)
    rng = np.random.default_rng(0)
    coeffs = tuple(
        torch.from_numpy(rng.integers(-64, 64, size=(c.padded_hb * c.padded_wb, 64)).astype(np.int32)).to(device)
        for c in frame.components
    )
    qtabs = tuple(torch.from_numpy(rng.integers(1, 64, size=(64,)).astype(np.int32)).to(device)
                  for _ in frame.components)

    def fn(coeffs, qtabs):
        return pipeline.transform_frame(frame, list(coeffs), list(qtabs), DEFAULT_CONFIG)

    return fn, (coeffs, qtabs)


def dryrun_mesh(n_devices: int, devices: Optional[Sequence] = None) -> Tuple[torch.device, ...]:
    """The dry run's mesh: `devices` if given (n_devices of them), else one
    device per card where there are n_devices cards or more, else card 0
    n_devices times. Raises RuntimeError without a card: it never makes a
    CPU mesh by itself."""
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
        if len(mesh) != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) was given {len(mesh)} devices")
        _require_card(mesh)
        return mesh
    _require_card([torch.device("cuda")])
    if torch.cuda.device_count() >= n_devices:
        return tuple(torch.device("cuda", i) for i in range(n_devices))
    return (torch.device("cuda", 0),) * n_devices


def _default_images(n: int) -> Tuple[List[bytes], List[str]]:
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        entry_ = json.load(f)["fixtures"][DRYRUN_FIXTURE]
    with open(os.path.join(FIXTURES, entry_["file"]), "rb") as f:
        data = f.read()
    return [data] * n, [entry_["pil_sha256"]] * n


def _grids(rng, frame, lo: int, hi: int) -> List[np.ndarray]:
    """One int32 [padded_blocks, 64] coefficient grid per component."""
    return [rng.integers(lo, hi, size=(c.padded_hb, c.padded_wb, 64)).astype(np.int32).reshape(-1, 64)
            for c in frame.components]


def _sharded_vs_single(frame, grids, qtabs, mesh, label: str) -> torch.Tensor:
    out = halo.sharded_transform(frame, grids, qtabs, DEFAULT_CONFIG, mesh)
    want_shape = (frame.height, frame.width, 3)
    _check(tuple(out.shape) == want_shape and out.device == mesh[0],
           f"path {label}: {tuple(out.shape)} on {out.device}, want {want_shape} on {mesh[0]}")
    single = pipeline.transform_frame(frame, [torch.from_numpy(g).to(mesh[0]) for g in grids],
                                      [torch.from_numpy(q).to(mesh[0]) for q in qtabs], DEFAULT_CONFIG)
    _check(torch.equal(out, single), f"path {label}: the sharded transform differs from the single-device one")
    return out


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     datas: Optional[Sequence[bytes]] = None,
                     sha256: Optional[Sequence[str]] = None) -> Dict:
    """Run the sharded paths over a mesh of n_devices (``dryrun_mesh``) and
    check each (the module's docstring lists them); raises AssertionError
    on a wrong result. Path 2 decodes `datas`, one image per shard, and
    holds image i to sha256[i], the SHA-256 of its pixels as PIL decodes
    them (default: n copies of the committed 420_odd fixture and its
    manifest hash). Returns {"shards", "devices" (distinct), "mesh",
    "outputs": {path: its result}}."""
    mesh = dryrun_mesh(n_devices, devices)
    n = n_devices
    outputs: Dict[str, object] = {}

    # Path 1: a (16n, 64) 4:2:0 frame, one MCU row per shard.
    frame = make_frame(16 * n, 64, H2V2)
    rng = np.random.default_rng(1)
    grids = _grids(rng, frame, -32, 32)
    qtabs = [rng.integers(1, 32, size=(64,)).astype(np.int32) for _ in frame.components]
    outputs["1"] = _sharded_vs_single(frame, grids, qtabs, mesh, "1")

    # Path 1a: 2n + 1 MCU rows, which do not divide among n shards: each
    # shard takes ceil((2n + 1) / n) rows (shard_spans), so the last ones
    # hold fewer or none, and the image has exactly its own rows. Path
    # 1's quantizers; the grids are the next draws.
    pframe = make_frame(16 * (2 * n + 1), 128, H2V2)
    outputs["1a"] = _sharded_vs_single(pframe, _grids(rng, pframe, -32, 32), qtabs, mesh, "1a")

    # Path 1b: the DC-predictor prefix fixup; row i lies on shard i's device.
    totals = torch.arange(3 * n, dtype=torch.int32).reshape(n, 3)
    fixed = halo.dc_prefix_fixup([totals[i].to(dev) for i, dev in enumerate(mesh)])
    expect = torch.cumsum(totals, 0) - totals
    for i, (f, dev) in enumerate(zip(fixed, mesh)):
        _check(f.device == dev and torch.equal(f.cpu(), expect[i]),
               f"path 1b: shard {i} got {f.tolist()} on {f.device}, want {expect[i].tolist()} on {dev}")
    outputs["1b"] = fixed

    # Path 2: the data-parallel fused decode, one image per shard.
    if datas is None:
        datas, sha256 = _default_images(n)
    elif sha256 is None or len(sha256) != len(datas):
        raise ValueError("dryrun_multichip: datas needs one sha256 of PIL's pixels per image")
    _check(len(datas) == n, f"path 2: {len(datas)} images for {n} shards")
    rgbs, failures = wf.decode_batch_to_rgb_sharded([bitstream.parse(d) for d in datas], DEFAULT_CONFIG,
                                                    mesh=mesh)
    _check(not failures, f"path 2: failures {failures}")
    images = [img for r in rgbs for img in r]
    _check(len(images) == n, f"path 2: {len(images)} images back for {n}")
    for i, (img, want) in enumerate(zip(images, sha256)):
        got = hashlib.sha256(img.contiguous().cpu().numpy().tobytes()).hexdigest()
        _check(got == want, f"path 2: image {i} does not hash to PIL's")
    outputs["2"] = images

    # Path 3: the data-parallel batched transform of n 32x32 4:2:0 images
    # with one quantizer set, split over the mesh.
    bframe = make_frame(32, 32, H2V2)
    coeffs = [rng.integers(-32, 32, size=(n, c.padded_hb * c.padded_wb, 64)).astype(np.int32)
              for c in bframe.components]
    bq = [np.tile(rng.integers(1, 32, size=(64,)).astype(np.int32), (n, 1)) for _ in bframe.components]
    per_image = [[torch.from_numpy(cf[k]) for cf in coeffs] for k in range(n)]
    got: List[Optional[torch.Tensor]] = [None] * n

    def emit(k: int, img: torch.Tensor) -> None:
        got[k] = img

    batch_lib.transform_over_mesh(bframe, per_image, [q[0] for q in bq], DEFAULT_CONFIG, mesh, emit)
    bout = torch.stack([img.to(mesh[0]) for img in got])
    _check(tuple(bout.shape) == (n, 32, 32, 3), f"path 3: {tuple(bout.shape)}")
    for k in range(n):
        single = pipeline.transform_frame(bframe, [c.to(mesh[0]) for c in per_image[k]],
                                          [torch.from_numpy(q[k]).to(mesh[0]) for q in bq], DEFAULT_CONFIG)
        _check(torch.equal(bout[k], single), f"path 3: image {k} differs from the single-device transform")
    outputs["3"] = bout

    return {"shards": n, "devices": len(set(mesh)), "mesh": [str(d) for d in mesh], "outputs": outputs}


def main() -> None:
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape), out.dtype, out.device)
    res = dryrun_multichip(4)
    print(f"dryrun_multichip(4) ok: {res['shards']} shards on {res['devices']} device(s) {res['mesh']}")


if __name__ == "__main__":
    main()
