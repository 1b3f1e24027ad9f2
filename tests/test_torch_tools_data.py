"""The port's data tools against the JAX package's scripts on the CPU:
``radar_depth_tpu_torch.generate_dataset`` against scripts/generate_dataset.py
and ``radar_depth_tpu_torch.import_pickles`` against scripts/
import_reference_pickles.py (every shard and day/night sidecar byte-equal,
at 64x96, 2 sweeps, a few samples), ``radar_depth_tpu_torch.rehearse``'s
fabricator against scripts/rehearse_real_scale.py's (equal arrays), and the
rehearsal itself with training skipped. Each JAX script runs as its own
process, ``python scripts/<name>.py``, as its users run it; the port's tools
run in this process."""

import contextlib
import importlib.util
import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from radar_depth_tpu_torch import generate_dataset, import_pickles, rehearse
from radar_depth_tpu_torch.data import schema
from radar_depth_tpu_torch.data.packed import PackedDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, SWEEPS = 64, 96, 2
SIZE = ["--height", str(H), "--width", str(W), "--sweeps", str(SWEEPS)]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv):
    """``python scripts/<name>.py ARGV`` -> (exit code, stdout)."""
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", f"{name}.py"), *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return proc.returncode, proc.stdout + proc.stderr


def _run_port(main, argv):
    """``main(ARGV)`` in this process -> (exit code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _files(root):
    """{path under root: bytes} of every file below ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _assert_same_tree(got, want):
    g, w = _files(got), _files(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k] == w[k], k
    return sorted(w)


def _flags(main, argv=("--help",)):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(list(argv))
    return {t.strip("[](),.") for t in out.getvalue().split()
            if t.startswith(("--", "[--"))}


@pytest.mark.parametrize("module,script", [
    (generate_dataset, "generate_dataset"),
    (import_pickles, "import_reference_pickles"),
    (rehearse, "rehearse_real_scale"),
])
def test_flags_match_jax_script(module, script, monkeypatch):
    jax_mod = _jax_script(script)
    monkeypatch.setattr(sys, "argv", [script, "--help"])
    want = _flags(lambda _: jax_mod.main())
    assert _flags(module.main) == want
    assert len(want) > 5


# ------------------------------------------------------- generate_dataset


@pytest.mark.parametrize("extra", [
    [],
    ["--night-severity", "0.7", "--night-frac", "0.5",
     "--val-night-frac", "1.0"],
    ["--max-shard-bytes", "1000000"],  # one record per shard at 64x96
], ids=["defaults", "night", "shards"])
def test_generate_dataset_matches_jax(tmp_path, extra):
    argv = ["--num-train", "5", "--num-val", "3", *SIZE, "--seed", "4", *extra]
    rc, want_out = _run_jax("generate_dataset",
                            ["--out", str(tmp_path / "jax"), *argv])
    assert rc == 0, want_out
    rc, got_out = _run_port(generate_dataset.main,
                            ["--out", str(tmp_path / "port"), *argv])
    assert rc == 0
    names = _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    shards = [n for n in names if n.startswith("train") and n.endswith(".rdtp")]
    assert len(names) == 2 * len([n for n in names if n.endswith(".rdtp")])
    assert len(shards) >= (3 if extra[:1] == ["--max-shard-bytes"] else 1)
    # the same report, times aside
    got_out = got_out.replace(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert [ln.rsplit(",", 1)[0] for ln in got_out.splitlines()] == [
        ln.rsplit(",", 1)[0] for ln in want_out.splitlines()]
    val = PackedDataset(str(tmp_path / "port" / "val"))
    try:
        assert len(val) == 3
        if extra[:1] == ["--night-severity"]:
            assert set(val.tags) == {"night"}
    finally:
        val.close()


# --------------------------------------------------------- import_pickles


def _fake_reference_pickle(rng, h, w, full_factor=1, radar_as_map=False):
    """A reference-style sample dict (tests/test_import_pickles.py's): CHW
    float image, a sparse GT map, radar as devkit-transposed points or a
    rasterized map, a 3x3 K."""
    H_, W_ = h * full_factor, w * full_factor
    img = rng.uniform(0, 1, (3, H_, W_)).astype(np.float32)  # CHW, [0,1]
    K = np.array([[0.6 * W_, 0, W_ / 2], [0, 0.6 * W_, H_ / 2], [0, 0, 1]],
                 np.float32)
    gt = np.zeros((H_, W_), np.float32)
    n_gt = 500
    uu = rng.integers(0, W_, n_gt)
    vv = rng.integers(0, H_, n_gt)
    gt[vv, uu] = rng.uniform(1.0, 70.0, n_gt).astype(np.float32)

    sample = {"im": img, "depth": gt, "K": K}
    n_r = 40
    ur = rng.integers(0, W_, n_r)
    vr = rng.integers(0, H_, n_r)
    zr = rng.uniform(2.0, 60.0, n_r).astype(np.float32)
    if radar_as_map:
        rmap = np.zeros((H_, W_), np.float32)
        rmap[vr, ur] = zr
        sample["sparse_depth"] = rmap
    else:
        x = (ur + 0.5 - K[0, 2]) / K[0, 0] * zr
        y = (vr + 0.5 - K[1, 2]) / K[1, 1] * zr
        pc = np.zeros((18, n_r), np.float32)  # devkit: (dims, N)
        pc[0], pc[1], pc[2] = x, y, zr
        sample["radar_pc"] = pc
    return sample


def _write_pickles(src, n, tagged=False, renamed=False, **kw):
    rng = np.random.default_rng(0)
    os.makedirs(src)
    paths = []
    for i in range(n):
        s = _fake_reference_pickle(rng, H, W, **kw)
        if tagged and i % 4 != 3:  # the 4th of each 4 carries no tag
            s["scene_description"] = ("Night, rain" if i % 3 == 0
                                      else "Sunny, parked cars")
        if renamed:
            s["camera_image"] = s.pop("im")
            s["radar_sparse"] = s.pop("sparse_depth")
        paths.append(os.path.join(src, f"{i:05d}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(s, f)
    return paths


IMPORT_CASES = {
    "points": (dict(), []),
    "map": (dict(radar_as_map=True), []),
    "fullres": (dict(full_factor=2, radar_as_map=True), []),
    "tagged": (dict(tagged=True), ["--max-shard-bytes", "1000000"]),
    "key_map": (dict(radar_as_map=True, renamed=True),
                ["--key-map", "image=camera_image", "radar_map=radar_sparse"]),
    "lists": (dict(tagged=True), None),
}


@pytest.mark.parametrize("case", sorted(IMPORT_CASES))
def test_import_pickles_matches_jax(tmp_path, case):
    kw, extra = IMPORT_CASES[case]
    paths = _write_pickles(str(tmp_path / "pickles"), 8, **kw)
    if extra is None:  # explicit split lists, in an order of their own
        for name, part in (("train.txt", paths[5::-2] + paths[:5:2]),
                           ("val.txt", paths[6:])):
            (tmp_path / name).write_text("\n".join(part) + "\n")
        extra = ["--train-list", str(tmp_path / "train.txt"),
                 "--val-list", str(tmp_path / "val.txt")]
    argv = ["--src", str(tmp_path / "pickles"), *SIZE,
            "--val-fraction", "0.25", *extra]
    rc, want_out = _run_jax("import_reference_pickles",
                            [*argv, "--out", str(tmp_path / "jax")])
    assert rc == 0, want_out
    rc, got_out = _run_port(import_pickles.main,
                            [*argv, "--out", str(tmp_path / "port")])
    assert rc == 0
    assert got_out.replace(str(tmp_path / "port"),
                           str(tmp_path / "jax")) == want_out
    names = _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    tags = [n for n in names if n.endswith(".tags.json")]
    assert bool(tags) == kw.get("tagged", False)
    spec = schema.SampleSpec(height=H, width=W, num_sweeps=SWEEPS)
    ds = PackedDataset(str(tmp_path / "port" / "train"))
    try:
        assert len(ds) == 6
        schema.validate_sample(ds[0], spec)
        assert ds[0]["radar_valid"][0].sum() > 0
        if tags:
            assert set(ds.tags) == {"day", "night"}
        assert len(ds.paths) >= (2 if "--max-shard-bytes" in extra else 1)
    finally:
        ds.close()


def test_import_pickle_without_k_raises_the_same(tmp_path):
    raw = _fake_reference_pickle(np.random.default_rng(1), H, W)
    del raw["K"]
    spec = schema.SampleSpec(height=H, width=W, num_sweeps=SWEEPS)
    with pytest.raises(KeyError) as want:
        _jax_script("import_reference_pickles").convert_sample(
            raw, spec, {}, {})
    with pytest.raises(KeyError) as got:
        import_pickles.convert_sample(raw, spec, {}, {})
    assert str(got.value) == str(want.value)
    assert "intrinsics" in str(got.value)


def test_import_empty_src_exits_1(tmp_path):
    (tmp_path / "empty").mkdir()
    argv = ["--src", str(tmp_path / "empty"), "--out", str(tmp_path / "out")]
    rc, out = _run_jax("import_reference_pickles", argv)
    assert rc == 1, out
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert import_pickles.main(argv) == 1
    assert err.getvalue() == f"no pickles under {tmp_path / 'empty'}\n"
    assert not (tmp_path / "out").exists()


# --------------------------------------------------------------- rehearse


@pytest.mark.parametrize("night,as_map", [(False, False), (True, True)],
                         ids=["day_points", "night_map"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fabricate_sample_matches_jax(seed, night, as_map):
    jax_reh = _jax_script("rehearse_real_scale")
    want = jax_reh.fabricate_sample(np.random.default_rng(seed), night=night,
                                    radar_as_map=as_map)
    got = rehearse.fabricate_sample(np.random.default_rng(seed), night=night,
                                    radar_as_map=as_map)
    assert sorted(got) == sorted(want)
    assert ("sparse_depth" in got) == as_map and ("radar_pc" in got) != as_map
    assert ("night" in got["scene_description"]) == night
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v
    assert got["im"].shape == (900, 1600, 3) and got["im"].dtype == np.uint8


def test_fabricate_matches_jax(tmp_path):
    """The pickles on disk, the per-sample seeds and night/map draws
    included."""
    kw = dict(num=3, seed=5, map_frac=0.5, night_frac=0.5)
    _jax_script("rehearse_real_scale").fabricate(str(tmp_path / "jax"), **kw)
    rehearse.fabricate(str(tmp_path / "port"), **kw)
    assert len(_assert_same_tree(tmp_path / "port", tmp_path / "jax")) == 3


def test_rehearse_without_training(tmp_path):
    """fabricate -> the importer in a child process -> >= 2 train shards,
    bounded RSS; the pickles are deleted after the import."""
    root = tmp_path / "reh"
    rc, out = _run_port(rehearse.main, [
        "--root", str(root), "--num", "8", "--skip-train",
        "--max-shard-bytes", str(4 << 20)])  # ~1 record per shard at 450x800
    assert rc == 0, out
    assert "PASS (train skipped)" in out and "PEAK_RSS_KB" in out
    assert not (root / "pickles").exists()
    train = PackedDataset(str(root / "packed" / "train"))
    try:
        assert len(train) == 7 and len(train.paths) >= 2
        assert set(train.tags) <= {"day", "night"}
        schema.validate_sample(train[0], schema.SampleSpec(num_sweeps=1))
    finally:
        train.close()


def test_importer_peak_rss_is_its_own(tmp_path):
    """The importer child's peak RSS excludes its parent's: Linux keeps
    ru_maxrss across exec, so a parent holding ~1 GB would otherwise show
    through."""
    rehearse.fabricate(str(tmp_path / "pickles"), num=2, seed=0,
                       map_frac=0.0, night_frac=0.5)
    ballast = np.ones(1 << 27)  # 1 GiB, resident
    rc, out = _run_port(lambda argv: rehearse.run_importer(*argv), [
        str(tmp_path / "pickles"), str(tmp_path / "out"), 1 << 30])
    assert ballast.sum() == 1 << 27
    assert rc < 0.7, out  # GB: the importer's own ~0.2-0.3
    assert len(PackedDataset(str(tmp_path / "out" / "train"))) == 1
