"""Write the committed JPEG fixtures and their manifest.

The card's host has neither PIL nor JAX, so the files that
``chip_smoke.py`` decodes, and the PIL (libjpeg-turbo) decode hashes it
holds the port to, are made where PIL is installed and committed:

    python tpujpeg_torch/fixtures/make_fixtures.py

Each file is a ``tests/corpus.py`` call; ``manifest.json`` records the
call, the path that takes it (``fused``: a restart-segmented single
scan, kernel A; ``norst``: a single baseline scan without restart
markers or with segments over the lane row, kernel A or 2 on the norst
plan; ``staged``: progressive without restarts or multi-scan, the
coefficient path with host entropy or kernel 2; ``progressive``:
restart-segmented progressive, the progressive scan kernels), the
decoded shape and the sha256 of PIL's decoded bytes.
``tests/test_torch_fixtures.py`` checks the manifest against PIL.

``faults`` in the manifest names the corruptions ``chip_smoke.py``
injects into one member of a batch, with the exception class the
reference decoder raises for it (checked by the same test).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# name -> corpus keyword arguments (make_jpeg unless "maker" names
# another generator). "420_2048" is bench.py's corpus shape (2048^2, q85,
# 4:2:0, restart every 4 MCUs, first seed); "prog_2048" and "norst_2048"
# are the same image written progressive and without restart markers, and
# "prog_rst_2048" progressive with its restart markers; "422_2048" and
# "444_2048" the same image and restart interval at 4:2:2 and 4:4:4.
# "rst_rows_420" restarts every MCU row, in segments over the restart
# planner's row cap. "prog_tsets_0".."_2" are three images of one odd size
# written progressive with restarts, each with its own optimized Huffman
# tables: one launch of each scan kernel with three table sets, and
# padding lanes between the images.
FIXTURES = {
    "420_2048": dict(w=2048, h=2048, seed=7, quality=85, subsampling=2, restart_blocks=4),
    "420_odd": dict(w=129, h=65, seed=9, quality=85, subsampling=2, restart_blocks=3),
    "422": dict(w=512, h=384, seed=11, quality=85, subsampling=1, restart_blocks=4),
    "444": dict(w=512, h=384, seed=12, quality=85, subsampling=0, restart_blocks=4),
    "gray": dict(w=512, h=384, seed=13, quality=85, mode="L", restart_blocks=4),
    "prog_2048": dict(w=2048, h=2048, seed=7, quality=85, subsampling=2, progressive=True),
    "norst_2048": dict(w=2048, h=2048, seed=7, quality=85, subsampling=2),
    "multiscan": dict(maker="make_multiscan_jpeg", w=512, h=384, seed=9, subsampling=2,
                      restart_blocks=4),
    "prog_rst_2048": dict(w=2048, h=2048, seed=7, quality=85, subsampling=2, progressive=True,
                          restart_blocks=4),
    "prog_444": dict(w=512, h=384, seed=12, quality=85, subsampling=0, progressive=True,
                     restart_blocks=4),
    "prog_gray": dict(w=512, h=384, seed=13, quality=85, mode="L", progressive=True,
                      restart_blocks=4),
    "rst_rows_420": dict(w=512, h=384, seed=14, quality=85, subsampling=2, restart_rows=1),
    "422_2048": dict(w=2048, h=2048, seed=7, quality=85, subsampling=1, restart_blocks=4),
    "444_2048": dict(w=2048, h=2048, seed=7, quality=85, subsampling=0, restart_blocks=4),
    **{f"prog_tsets_{i}": dict(w=201, h=153, seed=71 + i, quality=85, subsampling=2, progressive=True,
                               restart_blocks=2) for i in range(3)},
}
STAGED = ("prog_2048", "multiscan")
NORST = ("norst_2048", "rst_rows_420")
PROGRESSIVE = ("prog_rst_2048", "prog_444", "prog_gray", "prog_tsets_0", "prog_tsets_1", "prog_tsets_2")

# One member of a batch of `batch` copies of `fixture` gets its scan
# payload (restart markers included) overwritten with `fill` bytes; the
# parsed restart offsets stay, so the lanes keep their lengths.
FAULTS = [
    dict(fixture="420_odd", batch=3, member=1, fill=0x00, error="JpegHuffmanError"),
    dict(fixture="420_odd", batch=3, member=2, fill=0xFF, error="JpegHuffmanError"),
]


def call_text(kw) -> str:
    kw = dict(kw)
    maker, w, h = kw.pop("maker", "make_jpeg"), kw.pop("w"), kw.pop("h")
    return f"{maker}({w}, {h}, " + ", ".join(f"{k}={v!r}" for k, v in kw.items()) + ")"


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import corpus

    entries = {}
    for name, kw in FIXTURES.items():
        args = dict(kw)
        maker = getattr(corpus, args.pop("maker", "make_jpeg"))
        w, h = args.pop("w"), args.pop("h")
        data = maker(w, h, **args)
        with open(os.path.join(HERE, f"{name}.jpg"), "wb") as f:
            f.write(data)
        img = corpus.pil_decode(data)
        entries[name] = dict(
            file=f"{name}.jpg",
            call=call_text(kw),
            path=("staged" if name in STAGED else "norst" if name in NORST
                  else "progressive" if name in PROGRESSIVE else "fused"),
            shape=list(img.shape),
            file_sha256=hashlib.sha256(data).hexdigest(),
            pil_sha256=hashlib.sha256(img.tobytes()).hexdigest(),
        )
        print(name, len(data), "bytes", img.shape)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(dict(fixtures=entries, faults=FAULTS), f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
