"""The port's resumable batch job (tpujpeg_torch.parallel.manifest) on
device="cpu": tests/test_manifest.py's four cases, the outputs against
PIL (tolerance 0), and the records against the reference's job on the
same files."""

import glob
import json
import os

import numpy as np

from corpus import make_jpeg, pil_decode

from tpujpeg.parallel import manifest as ref_manifest

from tpujpeg_torch.parallel import manifest as manifest_lib


def _write_corpus(tmp_path, n=5):
    paths = []
    for i in range(n):
        p = tmp_path / f"img{i}.jpg"
        p.write_bytes(make_jpeg(64, 48, seed=i, subsampling=2))
        paths.append(str(p))
    return paths


def _records(out):
    return [json.loads(line) for line in open(os.path.join(out, "manifest.jsonl")) if line.strip()]


def test_batch_job_completes_and_resumes(tmp_path):
    paths = _write_corpus(tmp_path)
    out = str(tmp_path / "out")
    c1 = manifest_lib.run_batch_job(paths, out, device="cpu")
    assert c1 == {"completed": 5, "skipped": 0, "failed": 0}
    npys = sorted(f for f in os.listdir(out) if f.endswith(".npy"))
    assert len(npys) == 5
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0]
        got = [f for f in npys if f.startswith(name + ".")]
        assert len(got) == 1
        np.testing.assert_array_equal(np.load(os.path.join(out, got[0])), pil_decode(open(p, "rb").read()))
    c2 = manifest_lib.run_batch_job(paths, out, device="cpu")
    assert c2 == {"completed": 0, "skipped": 5, "failed": 0}


def test_batch_job_resumes_after_partial_manifest(tmp_path):
    paths = _write_corpus(tmp_path)
    out = str(tmp_path / "out")
    mpath = str(tmp_path / "out" / "manifest.jsonl")
    manifest_lib.run_batch_job(paths[:2], out, device="cpu")
    with open(mpath, "a") as f:  # a crash's torn trailing record
        f.write('{"status": "ok", "dig')
    c = manifest_lib.run_batch_job(paths, out, device="cpu")
    assert c["skipped"] == 2 and c["completed"] == 3


def test_batch_job_isolates_corrupt_file(tmp_path):
    paths = _write_corpus(tmp_path, n=2)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg at all")
    out = str(tmp_path / "out")
    c = manifest_lib.run_batch_job(paths + [str(bad)], out, device="cpu")
    assert c == {"completed": 2, "skipped": 0, "failed": 1}
    recs = _records(out)
    assert sum(r["status"] == "error" for r in recs) == 1


def test_batch_job_on_device_path(tmp_path):
    paths = _write_corpus(tmp_path, n=3)
    out = str(tmp_path / "out")
    c = manifest_lib.run_batch_job(paths, out, on_device=True, device="cpu")
    assert c == {"completed": 3, "skipped": 0, "failed": 0}
    f = sorted(glob.glob(os.path.join(out, "img0.*.npy")))[0]
    np.testing.assert_array_equal(np.load(f), pil_decode(open(paths[0], "rb").read()))


def test_records_digests_and_names_match_the_reference(tmp_path):
    paths = _write_corpus(tmp_path, n=2)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg at all")
    inputs = paths + [str(bad)]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert manifest_lib.run_batch_job(inputs, ours, device="cpu") == ref_manifest.run_batch_job(inputs, theirs)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    keys = ("status", "digest", "input")
    assert [{k: r[k] for k in keys} for r in _records(ours)] == [{k: r[k] for k in keys} for r in _records(theirs)]
    assert [os.path.basename(r.get("output", "")) for r in _records(ours)] == \
        [os.path.basename(r.get("output", "")) for r in _records(theirs)]
    assert manifest_lib.load_manifest(os.path.join(ours, "manifest.jsonl")).keys() == \
        ref_manifest.load_manifest(os.path.join(theirs, "manifest.jsonl")).keys()
