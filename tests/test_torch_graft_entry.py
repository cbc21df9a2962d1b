"""The port's graft entry points (tpujpeg_torch/graft_entry.py) on the
CPU, where the kernels' plain versions run, against the reference's
__graft_entry__.py: entry()'s step on the same draws, and each path of
dryrun_multichip(4) on ("cpu",) * 4 against the reference's counterpart
on the same numpy draws (paths 1 and 1a: halo._build_sharded_transform
over 4 of the 8 virtual XLA devices; 1b: its shard_map fixup; 3:
tpujpeg.transform.transform_frame per image; 2: PIL). Tolerance 0."""

import hashlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from corpus import make_jpeg, pil_decode

from tpujpeg import transform as ref_transform
from tpujpeg.parallel import halo as ref_halo

from tpujpeg_torch import graft_entry
from tpujpeg_torch.kernels import pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
MESH = ("cpu",) * N
H2V2 = ((2, 2), (1, 1), (1, 1))


def _reference_module():
    spec = importlib.util.spec_from_file_location("_ref_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # Its fd-2 filter of XLA:CPU loader lines would outlive the test.
    mod._FILTER_ON = True
    return mod


def _reference_draws(n):
    """The reference dry run's numpy draws, in its order
    (__graft_entry__.py: path 1's grids and quantizers, path 1a's grids,
    path 3's coefficients and quantizers)."""
    rng = np.random.default_rng(1)

    def grids(frame):
        return [rng.integers(-32, 32, size=(c.padded_hb, c.padded_wb, 64)).astype(np.int32)
                for c in frame.components]

    frame = graft_entry.make_frame(16 * n, 64, H2V2)
    g1 = grids(frame)
    q1 = [rng.integers(1, 32, size=(64,)).astype(np.int32) for _ in frame.components]
    g1a = grids(graft_entry.make_frame(16 * (2 * n + 1), 128, H2V2))
    bframe = graft_entry.make_frame(32, 32, H2V2)
    c3 = [rng.integers(-32, 32, size=(n, c.padded_hb * c.padded_wb, 64)).astype(np.int32)
          for c in bframe.components]
    q3 = [np.tile(rng.integers(1, 32, size=(64,)).astype(np.int32), (n, 1)) for _ in bframe.components]
    return g1, q1, g1a, c3, q3


@pytest.fixture(scope="module")
def datas():
    """The reference's path-2 images and the SHA-256 of PIL's pixels."""
    d = [make_jpeg(64, 48, seed=s, subsampling=2, restart_blocks=2) for s in range(N)]
    return d, [hashlib.sha256(pil_decode(x).tobytes()).hexdigest() for x in d]


@pytest.fixture(scope="module")
def dryrun(datas):
    return graft_entry.dryrun_multichip(N, devices=MESH, datas=datas[0], sha256=datas[1])


@pytest.fixture(scope="module")
def reference_rows():
    """The reference's paths 1 and 1a on the same grids, over 4 devices."""
    g1, q1, g1a, _c3, _q3 = _reference_draws(N)
    qtabs = [jnp.asarray(q) for q in q1]
    outs = []
    for h, w, grids in ((16 * N, 64, g1), (16 * (2 * N + 1), 128, g1a)):
        pad = (-(h // 16)) % N
        fn, frame, mesh = ref_halo._build_sharded_transform((h, w, H2V2, pad), N, "rows", True)
        put = [jax.device_put(np.pad(g, ((0, pad * c.v), (0, 0), (0, 0))), NamedSharding(mesh, P("rows")))
               for g, c in zip(grids, frame.components)]
        outs.append(np.asarray(fn(put, qtabs))[:h])
    return outs


def test_entry_equals_the_reference():
    ref_fn, ref_args = _reference_module().entry()
    want = np.asarray(jax.jit(ref_fn)(*ref_args))
    fn, args = graft_entry.entry(device="cpu")
    for ours, theirs in zip(args, ref_args):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = fn(*args)
    assert out.shape == (512, 512, 3) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), want)


def test_dryrun_returns_cleanly_on_cpu_devices():
    res = graft_entry.dryrun_multichip(N, devices=MESH)
    assert (res["shards"], res["devices"], res["mesh"]) == (N, 1, ["cpu"] * N)
    assert sorted(res["outputs"]) == ["1", "1a", "1b", "2", "3"]


def test_dryrun_paths_1_and_1a_equal_the_reference(dryrun, reference_rows):
    want1, want1a = reference_rows
    assert tuple(dryrun["outputs"]["1"].shape) == (16 * N, 64, 3)
    np.testing.assert_array_equal(dryrun["outputs"]["1"].numpy(), want1)
    # The port makes no padding rows: exactly 16 (2n + 1) of them.
    assert tuple(dryrun["outputs"]["1a"].shape) == (16 * (2 * N + 1), 128, 3)
    np.testing.assert_array_equal(dryrun["outputs"]["1a"].numpy(), want1a)


def test_dryrun_path_1b_equals_the_reference_fixup(dryrun):
    fx = jax.jit(shard_map(lambda local: ref_halo.dc_prefix_fixup(local[0], "rows")[None],
                           mesh=jax.make_mesh((N,), ("rows",)), in_specs=P("rows", None),
                           out_specs=P("rows", None), check_vma=False))
    want = np.asarray(fx(jnp.arange(N * 3, dtype=jnp.int32).reshape(N, 3)))
    got = dryrun["outputs"]["1b"]
    assert [t.device for t in got] == [torch.device("cpu")] * N
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)


def test_dryrun_path_2_equals_pil(dryrun, datas):
    images = dryrun["outputs"]["2"]
    assert len(images) == N
    for img, data in zip(images, datas[0]):
        np.testing.assert_array_equal(img.numpy(), pil_decode(data))


def test_dryrun_path_3_equals_the_reference_per_image(dryrun):
    _g1, _q1, _g1a, c3, q3 = _reference_draws(N)
    bframe = graft_entry.make_frame(32, 32, H2V2)
    out = dryrun["outputs"]["3"]
    assert tuple(out.shape) == (N, 32, 32, 3)
    for k in range(N):
        want = ref_transform.transform_frame(bframe, [jnp.asarray(c[k]) for c in c3],
                                             [jnp.asarray(q[k]) for q in q3])
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want))


def test_dryrun_raises_on_a_planted_fault(monkeypatch):
    """A color stage that flips one byte in the middle row of what it
    returns: the sharded windows put that row elsewhere in the image than
    the single-device transform does, so path 1 must fail."""
    kernel = pipeline._NHWC_KERNELS[pipeline._H2V2]

    def flipped(*planes):
        out = kernel(*planes).clone()
        out[:, out.shape[1] // 2, 0, 0] ^= 1
        return out

    monkeypatch.setitem(pipeline._NHWC_KERNELS, pipeline._H2V2, flipped)
    with pytest.raises(AssertionError, match="path 1"):
        graft_entry.dryrun_multichip(N, devices=MESH)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(N)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(N, devices=("cuda:0",) * N)


def test_dryrun_takes_n_devices_and_one_hash_per_image(datas):
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(N, devices=MESH[:2])
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(N, devices=MESH, datas=datas[0])
