"""Whole runs at a tiny size on the CPU (the look for a card skipped):
a sound run comes out correct, and a run whose timed path is broken
underneath comes out incorrect, for each fault a decode cell can have: an
answer altered where it is produced, half of each batch left out, and a
step that returns its buffer unchanged (the decode never written); on a
pool of one size and on a pool of mixed sizes added as files. A one-chip
decoder has no exchange between chips to leave out."""

import json

import pytest
import torch

import tpujpeg_torch
from jpegbench import run as R
from jpegbench.tests.tiny import MIXED_CELL, add_mixed_cell, tiny_root


def _altered(image):
    image = image.clone()
    image.view(-1)[0] ^= 1
    return image


def _fault_stream(kind):
    real = tpujpeg_torch.decode_stream

    def stream(*args, **kw):
        for chunk in real(*args, **kw):
            if kind == "altered":
                chunk.images = [_altered(im) for im in chunk.images]
            elif kind == "half_left_out":
                half = len(chunk.images) // 2
                chunk.images = chunk.images[:half] + [None] * (len(chunk.images) - half)
            elif kind == "unchanged":
                chunk.images = [torch.zeros_like(im) for im in chunk.images]
            yield chunk
    return stream


def _fault_decode(kind):
    real = tpujpeg_torch.decode
    calls = []

    def decode(*args, **kw):
        calls.append(1)
        if kind == "half_left_out" and len(calls) % 2:
            raise RuntimeError("left out")
        image = real(*args, **kw)
        if kind == "altered":
            return _altered(image)
        if kind == "unchanged":
            return torch.zeros_like(image)
        return image
    return decode


ARGS = ["--seed", "3000000019", "--seconds", "1", "--trace", "0"]


CELLS = {"stream_2048_420": ("decode_stream", _fault_stream), "uploads_4k_rst": ("decode", _fault_decode),
         MIXED_CELL: ("decode_stream", _fault_stream)}


def _root(tmp_path, cell):
    root = tiny_root(tmp_path)
    if cell == MIXED_CELL:
        add_mixed_cell(root)
    return root


@pytest.mark.parametrize("fault", ["altered", "half_left_out", "unchanged"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_timed_path_is_judged_incorrect(tmp_path, monkeypatch, cell, fault):
    args = R.parse_args(["--workload", cell] + ARGS)
    run = R.setup(args, "cpu", False, _root(tmp_path, cell))
    name, make = CELLS[cell]
    monkeypatch.setattr(tpujpeg_torch, name, make(fault))
    result = R.measure(run, args)
    assert result["attempted"] > 0
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_judged_correct_and_prints_its_checks_last(tmp_path, capsys, cell):
    rc = R.main(["--workload", cell] + ARGS, device="cpu", require_cuda=False, root=_root(tmp_path, cell))
    captured = capsys.readouterr()
    assert rc == 0
    result = json.loads(captured.out.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert captured.err.strip().splitlines()[-3:] == [
        f"check {k} {v['value']} limit {'>=' if k == 'checked' else '<='} {v['limit']}"
        for k, v in result["checks"].items()]
    # The CPU has no device trace: kernel_ms_per_mp is left out, not 0.
    assert set(result["metrics"]) == {"setup_s"}
    assert {"host_cpu_ms_per_mp", "decode_mp_per_s" if cell.startswith("stream") else "latency_p95_ms"} \
        <= set(result["host"])
