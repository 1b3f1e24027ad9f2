"""Rehearsal of the day-one chain with real nuScenes, the port's
``scripts/rehearse_real_scale.py``: reference-format pickles at the
camera's native 900x1600 (points and map-only radar, scene descriptions)
-> ``import_pickles`` (streamed, bounded memory, a child process) ->
multi-shard packed splits -> a short training run -> ``--evaluate
--eval-splits`` (day/night). The pickles are fabricated from a seed, since
no real pickle is in the repository; a directory of real ones is a drop-in
for ``ROOT/pickles`` with ``--skip-fabricate``.

    python -m radar_depth_tpu_torch.rehearse [--root DIR] [--num 2048] \\
        [--seed 0] [--map-frac 0.1] [--night-frac 0.25] \\
        [--max-shard-bytes N] [--epochs 2] [--skip-fabricate] \\
        [--skip-train] [--keep-src]

Training and evaluation run ``python -m radar_depth_tpu_torch.train.main``
with ``train_argv``'s flags, on the card (the port's default; without one
they stop with an error). Prints PASS and exits 0 when the importer's peak
RSS stays under 2 GB, the train split spans at least 2 shards and the run
holds train.csv, test.csv and best.txt; a failed check raises.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

FULL_H, FULL_W = 900, 1600  # nuScenes CAM_FRONT native resolution
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fabricate_sample(rng: np.random.Generator, night: bool,
                     radar_as_map: bool) -> dict:
    """One reference-format pickle dict at native resolution: a ground
    plane and fronto-parallel boxes rendered consistently into the image,
    the sparse GT depth and the radar (with ghosts and clutter), so a
    training run on it has signal to fit."""
    H, W = FULL_H, FULL_W
    fx = 1266.42
    cx, cy = W / 2.0, H / 2.0
    cam_h = 1.5
    K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float32)

    # dense depth field: ground plane + boxes (far to near)
    vv = np.arange(H, dtype=np.float32) + 0.5
    with np.errstate(divide="ignore"):
        ground_z = np.where(vv > cy + 1, fx * cam_h / (vv - cy), np.inf)
    dense = np.broadcast_to(ground_z[:, None], (H, W)).copy()
    img = np.empty((H, W, 3), np.float32)
    img[:] = np.array([0.55, 0.65, 0.85])  # sky
    gmask = np.isfinite(dense)
    shade = np.clip(1.0 - dense / 120.0, 0.2, 1.0)
    for c, base in enumerate((0.35, 0.33, 0.30)):
        img[..., c] = np.where(gmask, base * shade, img[..., c])

    n_boxes = int(rng.integers(6, 14))
    order = np.sort(rng.uniform(5.0, 70.0, n_boxes))[::-1]  # far -> near
    box_px = []
    for z in order:
        bw = rng.uniform(1.5, 6.0)
        bh = rng.uniform(1.0, 3.5)
        bx = rng.uniform(-20.0, 20.0)
        u0 = int(np.clip((bx - bw / 2) / z * fx + cx, 0, W))
        u1 = int(np.clip((bx + bw / 2) / z * fx + cx, 0, W))
        v1 = int(np.clip(cam_h / z * fx + cy, 0, H))          # ground contact
        v0 = int(np.clip((cam_h - bh) / z * fx + cy, 0, H))   # top
        if u1 <= u0 or v1 <= v0:
            continue
        albedo = rng.uniform(0.2, 0.9, 3)
        sh = np.clip(1.0 - z / 150.0, 0.3, 1.0)
        img[v0:v1, u0:u1] = albedo * sh
        dense[v0:v1, u0:u1] = z
        box_px.append((u0, u1, v0, v1, z))

    img += rng.normal(0, 0.015, img.shape)
    if night:
        img = img * 0.22 + rng.normal(0, 6.0 / 255.0, img.shape)
    img_u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)

    # sparse GT: a LiDAR-density random subset of the dense field
    gt = np.zeros((H, W), np.float32)
    n_gt = 40000
    uu = rng.integers(0, W, n_gt)
    vg = rng.integers(int(cy * 0.7), H, n_gt)
    z = dense[vg, uu]
    ok = np.isfinite(z) & (z > 0.5) & (z < 80.0)
    gt[vg[ok], uu[ok]] = z[ok]

    # radar: returns on boxes + multipath ghosts + clutter, in the camera
    # frame and ego-compensated, as the reference stores it
    pts = []
    for (u0, u1, v0, v1, z) in box_px:
        k = int(rng.poisson(3))
        if k == 0:
            continue
        ur = rng.uniform(u0, u1, k)
        zr = z + rng.normal(0, 0.15, k)
        x = (ur + 0.5 - cx) / fx * zr
        y = rng.normal(cam_h - 0.5, 0.4, k)
        pts.append(np.stack([x, y, zr], -1))
        if rng.uniform() < 0.4:  # ghost at k x range, same bearing
            g = rng.uniform(1.5, 2.4)
            pts.append(np.stack([x * g, y, zr * g], -1))
    n_cl = 8
    pts.append(np.stack([rng.uniform(-25, 25, n_cl),
                         rng.normal(cam_h - 0.5, 0.8, n_cl),
                         rng.uniform(2.0, 70.0, n_cl)], -1))
    pc = np.concatenate(pts, 0).astype(np.float32)
    proj_ok = pc[:, 2] > 1.0
    pc = pc[proj_ok][:120]

    sample = {
        "im": img_u8,  # HWC uint8 (the importer normalizes layouts)
        "depth": gt,
        "K": K,
        "scene_description": ("night drive, low light" if night
                              else "sunny day, clear"),
    }
    if radar_as_map:
        rmap = np.zeros((H, W), np.float32)
        u = np.clip(pc[:, 0] / pc[:, 2] * fx + cx, 0, W - 1).astype(int)
        v = np.clip(pc[:, 1] / pc[:, 2] * fx + cy, 0, H - 1).astype(int)
        rmap[v, u] = pc[:, 2]
        sample["sparse_depth"] = rmap
    else:
        sample["radar_pc"] = np.zeros((18, len(pc)), np.float32)
        sample["radar_pc"][0], sample["radar_pc"][1], sample["radar_pc"][2] = \
            pc[:, 0], pc[:, 1], pc[:, 2]
    return sample


def fabricate(src: str, num: int, seed: int, map_frac: float,
              night_frac: float) -> None:
    """``num`` pickles ``src/NNNNNN.pkl``, sample i drawn from
    SeedSequence([seed, i])."""
    os.makedirs(src, exist_ok=True)
    t0 = time.time()
    for i in range(num):
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        s = fabricate_sample(rng, night=rng.uniform() < night_frac,
                             radar_as_map=rng.uniform() < map_frac)
        with open(os.path.join(src, f"{i:06d}.pkl"), "wb") as f:
            pickle.dump(s, f, protocol=4)
        if (i + 1) % 256 == 0:
            rate = (i + 1) / (time.time() - t0)
            print(f"  fabricated {i + 1}/{num} ({rate:.1f}/s)", flush=True)


# The child: a small launcher that runs ``python -m
# radar_depth_tpu_torch.import_pickles ARGV`` and prints that process's
# peak RSS. Linux keeps ru_maxrss across exec, so a process started by a
# large one reports at least its parent's peak; started by the launcher,
# the importer's own peak is what RUSAGE_CHILDREN holds.
_IMPORTER = (
    "import resource, subprocess, sys\n"
    "rc = subprocess.call([sys.executable, '-m',\n"
    "                      'radar_depth_tpu_torch.import_pickles',\n"
    "                      *sys.argv[1:]])\n"
    "sys.stdout.flush()\n"
    "print('PEAK_RSS_KB',\n"
    "      resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss)\n"
    "sys.exit(rc)\n")


def run_importer(src: str, out: str, max_shard_bytes: int) -> float:
    """The importer in a child process, at 450x800, 1 sweep, 1/8 of the
    pickles to val; returns its peak RSS in GB (the bounded-memory
    contract). Raises if it fails."""
    argv = ["--src", os.path.abspath(src), "--out", os.path.abspath(out),
            "--height", "450", "--width", "800",
            "--sweeps", "1", "--val-fraction", "0.125",
            "--max-shard-bytes", str(max_shard_bytes)]
    r = subprocess.run([sys.executable, "-c", _IMPORTER, *argv], cwd=_REPO,
                       capture_output=True, text=True, timeout=7200)
    print(r.stdout[-2000:])
    if r.returncode != 0:
        print(r.stderr[-3000:])
        raise RuntimeError(f"importer failed rc={r.returncode}")
    rss_kb = int(r.stdout.split("PEAK_RSS_KB")[1].split()[0])
    return rss_kb / 1e6


def train_argv(out: str, run: str, epochs: int) -> list:
    """``train.main``'s flags of the rehearsal's run on the imported shards
    in ``out``; add ``--evaluate RUN --eval-splits`` to evaluate it."""
    return ["--arch", "resnet18_latefusion", "-b", "32",
            "--dtype", "bfloat16", "--epochs", str(epochs),
            "--lr", "0.01", "--height", "450", "--width", "800",
            "--num-sweeps", "1", "--dataset", "packed",
            "--data-root", out, "--output-dir", run]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root",
                   default=os.path.join(tempfile.gettempdir(), "rehearsal"))
    p.add_argument("--num", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--map-frac", type=float, default=0.1,
                   help="fraction of map-only radar pickles")
    p.add_argument("--night-frac", type=float, default=0.25)
    p.add_argument("--max-shard-bytes", type=int, default=1 << 30,
                   help="1 GiB shards: the 2k-sample train split spans "
                        "several")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--skip-fabricate", action="store_true")
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--keep-src", action="store_true",
                   help="keep the fabricated pickles (default: delete them "
                        "after a successful import, ~20 GB at the default "
                        "--num)")
    args = p.parse_args(argv)

    root = os.path.abspath(args.root)  # the children run from the repo
    src = os.path.join(root, "pickles")
    out = os.path.join(root, "packed")
    run = os.path.join(root, "run")

    if not args.skip_fabricate:
        print(f"[1/4] fabricating {args.num} reference-format pickles → {src}")
        fabricate(src, args.num, args.seed, args.map_frac, args.night_frac)
    size_gb = sum(os.path.getsize(os.path.join(src, f))
                  for f in os.listdir(src)) / 1e9
    print(f"      src size: {size_gb:.1f} GB, {len(os.listdir(src))} pickles")

    print("[2/4] importing (import_pickles, child process)")
    rss_gb = run_importer(src, out, args.max_shard_bytes)
    shards = sorted(os.listdir(os.path.join(out, "train")))
    n_shards = len([s for s in shards if s.endswith(".rdtp")])
    print(f"      importer peak RSS: {rss_gb:.2f} GB; train shards: {n_shards}")
    _check(rss_gb < 2.0,
           f"importer RSS {rss_gb:.2f} GB breaks the <2 GB contract")
    _check(n_shards >= 2, f"expected multi-shard train output, got {n_shards}")
    if not args.keep_src:
        shutil.rmtree(src)
        print("      fabricated pickles deleted (--keep-src to retain)")

    if args.skip_train:
        print("PASS (train skipped)")
        return 0

    print(f"[3/4] training {args.epochs} epochs on the imported shards")
    train_cmd = [sys.executable, "-m", "radar_depth_tpu_torch.train.main",
                 *train_argv(out, run, args.epochs)]
    r = subprocess.run(train_cmd, cwd=_REPO, timeout=14400)
    _check(r.returncode == 0, "training failed")

    print("[4/4] --evaluate --eval-splits on the run")
    r = subprocess.run(train_cmd + ["--evaluate", run, "--eval-splits"],
                       cwd=_REPO, timeout=7200)
    _check(r.returncode == 0, "evaluate failed")
    for f in ("train.csv", "test.csv", "best.txt"):
        _check(os.path.exists(os.path.join(run, f)), f)
    print("PASS: fabricate → import (multi-shard, bounded RSS) → train → "
          "eval-splits all green; put real pickles in ROOT/pickles and "
          "rerun with --skip-fabricate")
    return 0


if __name__ == "__main__":
    sys.exit(main())
