"""Reference-format per-sample pickles -> packed shards, the port's
``scripts/import_reference_pickles.py``; the shards and their day/night
sidecars are byte-equal to the JAX script's.

The reference's offline stage writes one pickle per sample holding roughly
{image, LiDAR depth map, radar points and/or a rasterized radar map, K,
scene metadata}. Each logical field is looked up under a list of candidate
keys (``KEY_CANDIDATES``, extended by ``--key-map``), and both radar forms
are accepted: a map-only pickle yields its points by unprojection.

What the conversion does (numpy, operation for operation the JAX
script's):
  * full-resolution inputs (e.g. 900x1600) are downsampled to the working
    resolution by an integer factor: the image by area average, sparse
    depth maps by the minimum over valid pixels (the z-buffer's min-depth
    rule), K scaled to match;
  * LiDAR points, which the pickles do not carry, are the GT map's pixels
    unprojected through K (the exact inverse of the rasterization), so
    augmentation can re-rasterize the GT;
  * radar points (devkit (dims, N) layouts transposed) land in sweep 0
    with identity transforms; the other sweeps stay masked out.

    python -m radar_depth_tpu_torch.import_pickles --src DIR --out OUT \\
        [--val-fraction 0.15] [--height 450] [--width 800] [--sweeps 5] \\
        [--train-list train.txt --val-list val.txt] [--max-shard-bytes N] \\
        [--key-map FIELD=PICKLE_KEY ...]

Samples and tags are streamed together (``itertools.tee`` over one
generator, consumed in step by ``write_shards``), so memory stays bounded
by one record. Exit status 1 when ``--src`` holds no pickle.
"""

from __future__ import annotations

import argparse
import itertools
import os
import pickle
import sys

import numpy as np

from radar_depth_tpu_torch.data import schema
from radar_depth_tpu_torch.data.packed import write_shards

# Candidate key names per logical field, most likely first.
KEY_CANDIDATES = {
    "image": ["image", "img", "rgb", "im"],
    "lidar_depth": ["lidar_depth", "depth", "depth_gt", "gt", "gt_depth",
                    "lidar_map", "annotated_depth"],
    "radar_points": ["radar_points", "radar_pc", "points_radar"],
    "radar_map": ["radar_map", "radar_depth", "radar", "sparse_depth", "d",
                  "radar_raw"],
    "intrinsics": ["K", "intrinsics", "cam_K", "camera_matrix", "cam_intrinsic"],
}

TAG_CANDIDATES = ["tag", "split_tag", "scene_description", "description",
                  "scene_desc", "meta"]


def _lookup(d: dict, field: str, extra: dict):
    for k in [extra.get(field)] + KEY_CANDIDATES[field]:
        if k and k in d:
            return d[k]
    return None


def _to_hwc_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (3, 4) and img.shape[0] < img.shape[-1]:
        img = np.transpose(img, (1, 2, 0))  # CHW -> HWC
    img = img[..., :3]
    if img.dtype != np.uint8:
        scale = 255.0 if img.max() <= 1.5 else 1.0
        img = np.clip(img * scale, 0, 255).astype(np.uint8)
    return img


def _area_downsample(img: np.ndarray, f: int) -> np.ndarray:
    h, w = img.shape[:2]
    img = img[: h - h % f, : w - w % f]
    hh, ww = img.shape[0] // f, img.shape[1] // f
    return img.reshape(hh, f, ww, f, -1).mean(axis=(1, 3)).astype(np.uint8)


def _min_downsample(depth: np.ndarray, f: int) -> np.ndarray:
    """Per f x f block, the minimum over valid (> 0) pixels, 0 if none."""
    h, w = depth.shape
    depth = depth[: h - h % f, : w - w % f]
    hh, ww = depth.shape[0] // f, depth.shape[1] // f
    blocks = depth.reshape(hh, f, ww, f).transpose(0, 2, 1, 3).reshape(hh, ww, -1)
    masked = np.where(blocks > 0, blocks, np.inf)
    out = masked.min(axis=-1)
    return np.where(np.isfinite(out), out, 0.0).astype(np.float32)


def _unproject(depth_map: np.ndarray, K: np.ndarray, max_points: int):
    """Sparse map -> camera-frame points (the inverse of the z-buffer
    projection); beyond ``max_points`` the nearest are kept."""
    v, u = np.nonzero(depth_map > 0)
    z = depth_map[v, u].astype(np.float32)
    if len(z) > max_points:
        keep = np.argsort(z)[:max_points]
        u, v, z = u[keep], v[keep], z[keep]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (u.astype(np.float32) + 0.5 - cx) / fx * z
    y = (v.astype(np.float32) + 0.5 - cy) / fy * z
    pts = np.stack([x, y, z], axis=-1).astype(np.float32)
    return pts, len(z)


def convert_sample(raw: dict, spec: schema.SampleSpec, key_map: dict,
                   stats: dict) -> dict:
    """One pickle's dict -> a schema sample at ``spec``'s resolution;
    drop and fallback counts accumulate in ``stats``."""
    img = _lookup(raw, "image", key_map)
    gt = _lookup(raw, "lidar_depth", key_map)
    K = _lookup(raw, "intrinsics", key_map)
    if img is None or gt is None or K is None:
        missing = [f for f, v in [("image", img), ("lidar_depth", gt),
                                  ("intrinsics", K)] if v is None]
        raise KeyError(f"pickle lacks required fields {missing}; keys present: "
                       f"{sorted(raw)[:20]} — pass --key-map field=name")
    img = _to_hwc_uint8(img)
    gt = np.asarray(gt, np.float32)
    if gt.ndim == 3:
        gt = gt[0] if gt.shape[0] == 1 else gt[..., 0]
    K = np.asarray(K, np.float32)[:3, :3]

    f = img.shape[0] // spec.height
    if f > 1 and img.shape[0] == f * spec.height:
        img = _area_downsample(img, f)
        gt = _min_downsample(gt, f)
        K = K.copy()
        K[:2] /= f
    if img.shape[:2] != (spec.height, spec.width):
        raise ValueError(f"image {img.shape[:2]} is not the working resolution "
                         f"{(spec.height, spec.width)} nor an integer multiple")

    # radar: points if present, else the map's pixels unprojected
    rpts = _lookup(raw, "radar_points", key_map)
    if rpts is not None:
        rpts = np.asarray(rpts, np.float32)
        if rpts.ndim == 2 and rpts.shape[0] in (3, 4, 5, 18) \
                and rpts.shape[0] < rpts.shape[1]:
            rpts = rpts.T  # devkit convention: (dims, N) -> (N, dims)
        rpts = rpts[..., :3]
    else:
        rmap = _lookup(raw, "radar_map", key_map)
        if rmap is None:
            raise KeyError("pickle has neither radar points nor a radar map")
        rmap = np.asarray(rmap, np.float32)
        if rmap.ndim == 3:
            rmap = rmap[0] if rmap.shape[0] == 1 else rmap[..., 0]
        if rmap.shape[0] != spec.height and rmap.shape[0] % spec.height == 0:
            rmap = _min_downsample(rmap, rmap.shape[0] // spec.height)
        rpts, _ = _unproject(rmap, K, spec.radar_points_per_sweep)
        stats["map_fallback"] = stats.get("map_fallback", 0) + 1

    # The reference's radar is ego-compensated and in the camera frame
    # already, so the sweeps collapse into sweep 0 with identity
    # transforms; the other sweep slots stay masked out.
    radar_points = np.zeros((spec.num_sweeps, spec.radar_points_per_sweep, 3),
                            np.float32)
    radar_valid = np.zeros((spec.num_sweeps, spec.radar_points_per_sweep),
                           bool)
    padded, mask, dropped = schema.pad_points(rpts, spec.radar_points_per_sweep)
    radar_points[0], radar_valid[0] = padded, mask
    stats["radar_dropped"] = stats.get("radar_dropped", 0) + dropped
    radar_transform = np.tile(np.eye(4, dtype=np.float32),
                              (spec.num_sweeps, 1, 1))

    lidar_pts, n_lidar = _unproject(gt, K, spec.lidar_points)
    lpad, lmask, ldrop = schema.pad_points(lidar_pts, spec.lidar_points)
    stats["lidar_dropped"] = stats.get("lidar_dropped", 0) + ldrop

    sample = {
        "image": img,
        "lidar_depth": gt.astype(np.float32),
        "lidar_points": lpad,
        "lidar_valid": lmask,
        "radar_points": radar_points,
        "radar_valid": radar_valid,
        "radar_transform": radar_transform,
        "intrinsics": K.astype(np.float32),
    }
    schema.validate_sample(sample, spec)
    return sample


def _extract_tag(raw: dict):
    """'day' / 'night' from the pickle's scene metadata (nuScenes scene
    descriptions mention 'night'), or None when it carries none."""
    for k in TAG_CANDIDATES:
        v = raw.get(k)
        if isinstance(v, dict):
            v = v.get("description") or v.get("tag")
        if isinstance(v, str) and v:
            return "night" if "night" in v.lower() else "day"
    return None


def _list_pickles(src: str):
    out = []
    for root, _, files in os.walk(src):
        for f in sorted(files):
            if f.endswith((".pkl", ".pickle", ".p")):
                out.append(os.path.join(root, f))
    return sorted(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True, help="directory of per-sample pickles")
    p.add_argument("--out", required=True)
    p.add_argument("--height", type=int, default=schema.MODEL_HEIGHT)
    p.add_argument("--width", type=int, default=schema.MODEL_WIDTH)
    p.add_argument("--sweeps", type=int, default=schema.DEFAULT_NUM_SWEEPS)
    p.add_argument("--val-fraction", type=float, default=0.15)
    p.add_argument("--train-list", default="", help="file of pickle paths")
    p.add_argument("--val-list", default="")
    p.add_argument("--max-shard-bytes", type=int, default=4 << 30,
                   help="roll packed output to a new shard file at this size "
                        "(streaming writes, bounded memory)")
    p.add_argument("--key-map", nargs="*", default=[],
                   metavar="FIELD=PICKLE_KEY",
                   help="override key lookup, e.g. lidar_depth=depth_png")
    args = p.parse_args(argv)

    key_map = dict(kv.split("=", 1) for kv in args.key_map)
    spec = schema.SampleSpec(height=args.height, width=args.width,
                             num_sweeps=args.sweeps)

    if args.train_list or args.val_list:
        def read_list(path):
            with open(path) as f:
                return [ln.strip() for ln in f if ln.strip()]
        splits = {"train": read_list(args.train_list) if args.train_list else [],
                  "val": read_list(args.val_list) if args.val_list else []}
    else:
        paths = _list_pickles(args.src)
        if not paths:
            print(f"no pickles under {args.src}", file=sys.stderr)
            return 1
        n_val = max(1, int(len(paths) * args.val_fraction))
        splits = {"train": paths[:-n_val], "val": paths[-n_val:]}

    for split, paths in splits.items():
        if not paths:
            continue
        stats: dict = {}

        # the first pickle decides whether the split carries day/night
        # metadata; if so, tags stream beside the samples into the sidecars
        with open(paths[0], "rb") as f:
            has_tags = _extract_tag(pickle.load(f)) is not None

        def pairs():
            for path in paths:
                with open(path, "rb") as f:
                    raw = pickle.load(f)
                tag = _extract_tag(raw) or "day"
                yield convert_sample(raw, spec, key_map, stats), tag

        out_dir = os.path.join(args.out, split)
        s_it, t_it = itertools.tee(pairs())  # consumed in step: O(1) buffer
        shards = write_shards(
            out_dir, (s for s, _ in s_it),
            tags=(t for _, t in t_it) if has_tags else None,
            max_shard_bytes=args.max_shard_bytes)
        size_mb = sum(os.path.getsize(q) for q in shards) / 1e6
        print(f"{split}: {len(paths)} pickles → {out_dir} "
              f"({len(shards)} shard(s), {size_mb:.0f} MB, "
              f"tags={'yes' if has_tags else 'no'}); "
              f"drops/fallbacks: {stats or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
