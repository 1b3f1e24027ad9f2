"""The port's packed shards and native loader (radar_depth_tpu_torch/data/
packed.py) against the JAX package's (radar_depth_tpu/data/packed.py): the
same bytes on disk, the same arrays from both readers, and the same batches
from both NativeBatchLoaders with and without host augmentation, at the
harness tests' size (64x96, 2 sweeps)."""

import ctypes
import os
import shutil

import numpy as np
import pytest

from radar_depth_tpu.data import packed as jpacked
from radar_depth_tpu.data.synthetic import SyntheticNuScenes as JaxSynthetic
from radar_depth_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.data import packed
from radar_depth_tpu_torch.data.schema import SAMPLE_KEYS
from radar_depth_tpu_torch.ops.augment import AugmentConfig

SPEC = SampleSpec(height=64, width=96, num_sweeps=2, lidar_points=2048)
N = 16


def _assert_batches_equal(got, want):
    assert set(got) == set(want) == set(SAMPLE_KEYS)
    for k in SAMPLE_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """One split written by each package from the same samples, with day /
    night tags, in two shards each (the second rolls at 10 records)."""
    root = tmp_path_factory.mktemp("packed")
    ds = SyntheticNuScenes(N, spec=SPEC, seed=3)
    samples = [ds[i] for i in range(N)]
    tags = [ds.sample_tag(i) for i in range(N)]
    rec = packed.build_header(packed._fields_of(samples[0]), 0)[1]
    port = packed.write_shards(str(root / "port"), samples, tags=tags,
                               max_shard_bytes=10 * rec)
    jax_paths = jpacked.write_shards(str(root / "jax"), samples, tags=tags,
                                     max_shard_bytes=10 * rec)
    return root, ds, samples, tags, port, jax_paths


def test_synthetic_copy_matches_jax():
    """The port's SyntheticNuScenes copy draws the JAX package's samples."""
    got = SyntheticNuScenes(3, spec=SPEC, seed=3).batch(range(3))
    want = JaxSynthetic(3, spec=SPEC, seed=3).batch(range(3))
    _assert_batches_equal(got, want)


def test_writers_produce_identical_files(split):
    root, _, _, _, port, jax_paths = split
    assert [os.path.basename(p) for p in port] == [
        os.path.basename(p) for p in jax_paths] == ["data-00000.rdtp",
                                                    "data-00001.rdtp"]
    for a, b in zip(port, jax_paths):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        with open(a + ".tags.json") as fa, open(b + ".tags.json") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_readers_agree_across_packages(split, writer, use_native):
    """Shards of either writer read back equal to the samples, through
    both packages' readers (native mmap and numpy memmap), tags included."""
    root, ds, samples, tags, _, _ = split
    path = str(root / writer)
    mine = packed.PackedDataset(path, use_native=use_native)
    theirs = jpacked.PackedDataset(path, use_native=use_native)
    assert mine.native == use_native
    assert len(mine) == len(theirs) == N
    assert mine.tags == theirs.tags == tags
    idx = [15, 0, 9, 10, 3]
    got, want = mine.batch(idx), theirs.batch(idx)
    _assert_batches_equal(got, want)
    _assert_batches_equal(got, {k: np.stack([samples[i][k] for i in idx])
                                for k in SAMPLE_KEYS})
    mine.close()
    theirs.close()


@pytest.mark.parametrize("augment", [False, True])
def test_native_loader_matches_jax(split, augment):
    """Both NativeBatchLoaders over one split, the same seed and thread
    count, with and without worker-side augmentation: equal batches across
    an epoch boundary, in the same (epoch, index) order. Different thread
    counts give the same stream."""
    root = split[0]
    path = str(root / "port")
    ds, jds = packed.PackedDataset(path), jpacked.PackedDataset(path)
    aug = AugmentConfig() if augment else None
    jaug = JaxAugmentConfig() if augment else None
    mine = packed.NativeBatchLoader(ds, 4, seed=11, threads=3, augment=aug)
    other = packed.NativeBatchLoader(ds, 4, seed=11, threads=1, augment=aug)
    theirs = jpacked.NativeBatchLoader(jds, 4, seed=11, threads=3,
                                       augment=jaug)
    plain = packed.NativeBatchLoader(ds, 4, seed=11, threads=2)
    try:
        for step in range(6):  # 4 batches per epoch
            got, want = next(mine), next(theirs)
            _assert_batches_equal(got, want)
            _assert_batches_equal(next(other), got)
            assert (mine.epoch, mine.index_in_epoch) == (
                theirs.epoch, theirs.index_in_epoch) == (step // 4, step % 4)
            unaugmented = next(plain)
            changed = not np.array_equal(got["image"], unaugmented["image"])
            assert changed == augment
            np.testing.assert_array_equal(got["radar_points"],
                                          unaugmented["radar_points"])
    finally:
        for loader in (mine, other, theirs, plain):
            loader.close()


def test_loader_rejects_bad_batch_and_fallback_reader(split):
    root = split[0]
    ds = packed.PackedDataset(str(root / "port"))
    with pytest.raises(ValueError, match="batch_size"):
        packed.NativeBatchLoader(ds, N + 1)
    with pytest.raises(RuntimeError, match="requires librdtp"):
        packed.NativeBatchLoader(
            packed.PackedDataset(str(root / "port"), use_native=False), 4)
    assert packed.native_available() and packed.native_error() is None


def test_layout_mismatch_and_stale_sidecar(tmp_path, split):
    _, ds, samples, _, _, _ = split
    other = SyntheticNuScenes(2, spec=SampleSpec(height=32, width=48,
                                                 num_sweeps=2,
                                                 lidar_points=2048), seed=1)
    packed.write_shard(str(tmp_path / "mix" / "a.rdtp"), samples[:2])
    packed.write_shard(str(tmp_path / "mix" / "b.rdtp"),
                       [other[0], other[1]])
    with pytest.raises(IOError, match="record layout differs"):
        packed.PackedDataset(str(tmp_path / "mix"))
    path = str(tmp_path / "one" / "data.rdtp")
    packed.write_shard(path, samples[:3], tags=["day", "night", "day"])
    with open(path + ".tags.json", "w") as f:
        f.write('["day"]')
    with pytest.warns(UserWarning, match="stale sidecar"):
        assert packed.PackedDataset(path).tags is None
    # a tag-less rewrite removes the sidecar
    packed.write_shard(path, samples[:3])
    assert not os.path.exists(path + ".tags.json")
    assert packed.PackedDataset(path).sample_tag(0) == "all"


def test_native_build_without_make(tmp_path, monkeypatch):
    """Where make is missing, the library is built by native/Makefile's g++
    line, and it loads."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    src = tmp_path / "native"
    src.mkdir()
    shutil.copy(os.path.join(packed.NATIVE_DIR, "rdtp_loader.cc"), src)
    monkeypatch.setattr(packed, "NATIVE_DIR", str(src))
    monkeypatch.setattr(packed, "_LOCK_DIR", str(tmp_path / "lock"))
    monkeypatch.setattr(packed.shutil, "which", lambda name: None)
    so = str(src / "librdtp.so")
    packed._build_native(so)
    lib = ctypes.CDLL(so)
    assert hasattr(lib, "rdtp_loader_create")
    assert not [p for p in os.listdir(src) if p.endswith(".tmp")]
