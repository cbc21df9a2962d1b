"""The port's command line (tpujpeg_torch.cli) with --device cpu: info
prints the reference's JSON, decode writes .npy and .ppm equal to PIL
(tolerance 0), bench prints its JSON line, batch exits 0, resumes and
exits 2 on a corrupt member, and ``python -m tpujpeg_torch.cli`` runs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from corpus import make_jpeg, pil_decode

from tpujpeg import cli as ref_cli

from tpujpeg_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jpeg(tmp_path):
    p = tmp_path / "in.jpg"
    p.write_bytes(make_jpeg(64, 48, seed=3, subsampling=2, restart_blocks=2))
    return str(p)


@pytest.mark.parametrize("kind", ["420_rst", "gray", "progressive"])
def test_info_prints_the_reference_json(tmp_path, capsys, kind):
    data = {"420_rst": make_jpeg(64, 48, seed=3, subsampling=2, restart_blocks=2),
            "gray": make_jpeg(40, 24, seed=4, mode="L"),
            "progressive": make_jpeg(64, 48, seed=5, progressive=True)}[kind]
    p = tmp_path / "x.jpg"
    p.write_bytes(data)
    assert cli.main(["info", str(p)]) == 0
    ours = capsys.readouterr().out
    assert ref_cli.main(["info", str(p)]) == 0
    assert ours == capsys.readouterr().out
    assert json.loads(ours)["width"] == {"420_rst": 64, "gray": 40, "progressive": 64}[kind]


@pytest.mark.parametrize("ext", [".npy", ".ppm"])
def test_decode_writes_pil_bytes(tmp_path, capsys, jpeg, ext):
    out = str(tmp_path / ("out" + ext))
    assert cli.main(["decode", jpeg, out, "--device", "cpu"]) == 0
    assert "64x48 (baseline, 1 scan(s)" in capsys.readouterr().out
    want = pil_decode(open(jpeg, "rb").read())
    if ext == ".npy":
        got = np.load(out)
    else:
        raw = open(out, "rb").read()
        header = b"P6\n64 48\n255\n"
        assert raw.startswith(header)
        got = np.frombuffer(raw[len(header):], np.uint8).reshape(48, 64, 3)
    np.testing.assert_array_equal(got, want)


def test_decode_with_engines_and_profile(tmp_path, capsys, jpeg):
    out = str(tmp_path / "out.npy")
    trace = tmp_path / "trace"
    assert cli.main(["decode", jpeg, out, "--device", "cpu", "--entropy", "python",
                     "--transform", "torch", "--profile", str(trace)]) == 0
    assert "entropy[python]" in capsys.readouterr().out
    assert (trace / "trace.json").stat().st_size > 0
    np.testing.assert_array_equal(np.load(out), pil_decode(open(jpeg, "rb").read()))


def test_bench_prints_its_json_line(capsys, jpeg):
    assert cli.main(["bench", jpeg, "--repeats", "2", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"megapixels", "best_ms", "mean_ms", "mp_per_s", "entropy_engine", "entropy_engines_seen"}
    assert rec["entropy_engine"] == "wavefront-fused"


def test_batch_exit_codes_and_resume(tmp_path, capsys):
    paths = []
    for i in range(3):
        p = tmp_path / f"img{i}.jpg"
        p.write_bytes(make_jpeg(64, 48, seed=i, subsampling=2))
        paths.append(str(p))
    out = str(tmp_path / "out")
    assert cli.main(["batch", *paths, "--out", out, "--device", "cpu", "--on-device"]) == 0
    assert json.loads(capsys.readouterr().out) == {"completed": 3, "skipped": 0, "failed": 0}
    assert cli.main(["batch", *paths, "--out", out, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == {"completed": 0, "skipped": 3, "failed": 0}
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg at all")
    assert cli.main(["batch", *paths, str(bad), "--out", out, "--device", "cpu"]) == 2
    assert json.loads(capsys.readouterr().out) == {"completed": 0, "skipped": 3, "failed": 1}


def test_python_dash_m_runs(jpeg):
    res = subprocess.run([sys.executable, "-m", "tpujpeg_torch.cli", "info", jpeg],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["mcus"] == [4, 3]
