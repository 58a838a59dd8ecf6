"""Each rank's share of a global batch (``se3conv3d_tpu_torch/parallel``)
against the JAX package's multi-host pipeline on the same inputs:
``process_slice``, ``local_batch_size``, ``pad_samples_to`` (the empty
slice with a template) and ``pad_batch_to_multiple`` equal JAX's; each
rank's batch stream of the run loop equals the JAX run loop's bitwise, the
JAX side with ``jax.process_index`` / ``jax.process_count`` patched to
``(r, 2)`` (the DFaust fixture, and a ScanNet fixture with Mix3D, whose
one-scene eval batches leave rank 1 an empty slice); ``cross_host_sum``
over two gloo ranks sums in float64 / int64 (the JAX one gathers through
32-bit arrays without x64, its own note: a recorded deviation) and is the
identity in one process; ``points > 1`` describes a ``(data, points)``
grid, with the JAX package's error where ``points`` does not divide the
devices (``tests/test_torch_points.py`` runs it)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_run import TorchRecorder, JaxRecorder, _recording, both

import torch_ddp_ranks as R
from se3conv3d_tpu.data.loaders import pad_collate as jcollate
from se3conv3d_tpu.parallel import mesh as jmesh
from se3conv3d_tpu.parallel import multihost as jmulti

from se3conv3d_tpu_torch.data import pad_collate
from se3conv3d_tpu_torch.parallel import mesh, multihost
from se3conv3d_tpu_torch.train import metrics as tmetrics
from se3conv3d_tpu_torch.train import run as trun

torch.set_num_threads(2)


def _sample(n, seed):
    rng = np.random.default_rng(seed)
    return {"positions": rng.standard_normal((n, 3)).astype(np.float32),
            "features": rng.standard_normal((n, 2)).astype(np.float32),
            "labels": rng.integers(0, 5, n).astype(np.int64), "label": np.int64(seed % 7)}


def _same_batches(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


@pytest.mark.parametrize("b,count", [(8, 4), (9, 4), (3, 4), (5, 2), (7, 2), (1, 3), (11, 1)])
def test_slices_and_agreed_counts_match_jax(b, count):
    ids = list(np.arange(100, 100 + b))
    for r in range(count):
        assert multihost.process_slice(ids, r, count) == jmulti.process_slice(ids, r, count)
    assert multihost.local_batch_size(b, count) == jmulti.local_batch_size(b, count)
    # the slices partition the batch, and the agreed count covers the largest
    slices = [multihost.process_slice(ids, r, count) for r in range(count)]
    assert sorted(sum(slices, [])) == ids
    assert max(map(len, slices)) == multihost.local_batch_size(b, count)


def test_pad_samples_to_matches_jax():
    samples = [_sample(40, 0), _sample(25, 1)]
    for target in (2, 4):
        _same_batches(pad_collate(multihost.pad_samples_to(list(samples), target), capacity=64),
                      jcollate(jmulti.pad_samples_to(list(samples), target), capacity=64))
    # an empty slice: fillers shaped by the template
    got = pad_collate(multihost.pad_samples_to([], 3, samples[1]), capacity=64)
    _same_batches(got, jcollate(jmulti.pad_samples_to([], 3, samples[1]), capacity=64))
    assert not got["mask"].any() and (got["label"] == 0).all()
    for args in (([], 2), (samples, 1)):
        with pytest.raises(ValueError):
            multihost.pad_samples_to(*args)


def test_pad_batch_to_multiple_matches_jax():
    batch = pad_collate([_sample(10 + i, i) for i in range(5)], capacity=16)
    for multiple in (1, 2, 4):
        got, want = mesh.pad_batch_to_multiple(batch, multiple), jmesh.pad_batch_to_multiple(batch, multiple)
        assert sorted(got) == sorted(want)  # jax.tree_util returns the keys sorted
        _same_batches({k: got[k] for k in sorted(got)}, {k: want[k] for k in sorted(want)})


def _as_rank(monkeypatch, r, count):
    monkeypatch.setattr(jax, "process_index", lambda: r)
    monkeypatch.setattr(jax, "process_count", lambda: count)
    for mod in (mesh, trun):
        monkeypatch.setattr(mod, "rank", lambda: r)
        monkeypatch.setattr(mod, "world_size", lambda: count)


@pytest.mark.parametrize("name", ["dfaust", "scannet20"])
@pytest.mark.parametrize("r", [0, 1])
def test_each_ranks_batch_stream_is_the_jax_run_loops(name, r, tmp_path, monkeypatch):
    jexp, texp = both(name, tmp_path)
    _as_rank(monkeypatch, r, 2)  # after orbax's CheckpointManager has read the process count
    jlog, tlog = [], []
    jexp.trainer = JaxRecorder(jlog)
    jexp._trainer_for_frames = lambda f: JaxRecorder(jlog, f)
    texp.trainer = TorchRecorder(tlog)
    batches = texp._batches
    texp._batches = lambda ds, train, times=None: _recording(batches(ds, train, times), tlog, ds, texp)
    state = jexp.calibrate(jexp.init_state())
    texp.init_state()
    texp.calibrate()
    for epoch in range(2):
        jexp.train_epoch(state, epoch)
        texp.train_epoch(epoch)
    texp._batches = batches
    assert [k for k, _, _ in tlog] == [k for k, _, _ in jlog] and len(tlog) >= 4
    for (kind, jb, _), (_, tb, _) in zip(jlog, tlog):
        for key in ("positions", "mask", "features", "labels"):
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]), err_msg=f"{kind} {key}")
    fillers = 0
    for jb, tb in zip(jexp._batches(jexp.val_ds, False), texp._batches(texp.val_ds, False), strict=True):
        _same_batches(tb, jb)
        fillers += int((~tb["mask"].any(1)).sum())
    if name == "scannet20":  # one scene per eval batch: rank 1's slice is empty
        assert fillers == (2 if r == 1 else 0)


def test_cross_host_sum_is_float64_and_int64_over_two_ranks():
    big = 2 ** 40
    values = {r: {"f": np.array([1e16, 0.5, 1e-12 * (r + 1)]) + r, "i": np.array([big + r, 3], np.int64),
                  "m": tmetrics.SemSegMetrics.empty(3).update([0, 1, 2, r], [0, 1, 1, r], [1, 1, 1, 1]),
                  "n": (np.float32(0.25 * (r + 1)), 7 + r)} for r in range(2)}
    got = R.launch_sums(values)
    want_f = values[0]["f"] + values[1]["f"]
    for out in got:
        np.testing.assert_array_equal(out["f"], want_f)
        assert out["f"].dtype == np.float64
        np.testing.assert_array_equal(out["i"], [2 * big + 1, 6])
        assert out["i"].dtype == np.int64
        m = out["m"]
        assert dataclasses.is_dataclass(m) and m.intersection.dtype == np.int64
        np.testing.assert_array_equal(m.intersection, values[0]["m"].intersection + values[1]["m"].intersection)
        assert float(out["n"][0]) == 0.75 and int(out["n"][1]) == 15
    # the deviation: a sum routed through 32-bit arrays loses these digits
    assert int(np.int32(np.int64(big + 1) % 2 ** 31)) + int(np.int32(big % 2 ** 31)) != 2 * big + 1
    assert np.float32(1e16 + 1.0) + np.float32(1e16) != want_f[0]
    # one process: the identity, the same objects back
    tree = values[0]
    assert multihost.cross_host_sum(tree) is tree


def test_points_axis_builds_a_grid():
    g = mesh.make_group(2, devices=["cpu", "cpu"], points=2)
    assert (g.size, g.data, g.points) == (2, 1, 2)
    assert mesh.make_group(4, devices=["cpu"] * 4).points == 1
    with pytest.raises(ValueError, match="2 devices not divisible by points=3"):
        mesh.make_group(2, devices=["cpu", "cpu"], points=3)
    assert mesh.local_rows(7, 0, 2) == (0, 4) and mesh.local_rows(7, 1, 2) == (4, 7)
    assert mesh.local_rows(1, 1, 2) == (1, 1) and mesh.points_size() == 1 and mesh.points_rank() == 0
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        mesh.make_group(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="one rank per card"):
        mesh.make_group(2, devices=["cuda:0", "cuda:0"], backend="nccl")
    assert mesh.make_group(2, devices=["cpu", "cpu"]).backend == "gloo"
    assert not mesh.in_group() and mesh.rank() == 0 and mesh.world_size() == 1
