"""Comparison panels (``radar_depth_tpu/utils/viz.py``): rows of [RGB |
sparse radar | GT depth | prediction] with colormapped depth, stacked across
samples and saved as PNG. numpy and the standard library only: the PNG is
written with ``zlib`` and ``struct``."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def colormap_depth(depth: np.ndarray, max_depth: float = 80.0) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8 on a jet-like ramp; invalid (<= 0)
    pixels black."""
    d = np.clip(depth / max_depth, 0.0, 1.0)
    valid = depth > 0
    r = np.clip(1.5 - np.abs(4 * d - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * d - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * d - 1), 0, 1)
    rgb = np.stack([r, g, b], axis=-1)
    rgb = np.where(valid[..., None], rgb, 0.0)
    return (rgb * 255).astype(np.uint8)


def _dilate_sparse(depth: np.ndarray, it: int = 1) -> np.ndarray:
    """Max-dilate sparse depth, for display only."""
    out = depth.copy()
    for _ in range(it):
        p = np.pad(out, 1)
        stacked = np.stack([
            p[1:-1, 1:-1], p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:],
        ])
        out = stacked.max(axis=0)
    return out


def merge_into_row(rgb: np.ndarray, sparse: np.ndarray, target: np.ndarray,
                   pred: np.ndarray, max_depth: float = 80.0) -> np.ndarray:
    """One sample -> one (H, 4W, 3) uint8 strip. rgb (H, W, 3) in [0, 1];
    sparse, target, pred (H, W) depth in meters."""
    img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    cols = [
        img,
        colormap_depth(_dilate_sparse(sparse, 2), max_depth),
        colormap_depth(_dilate_sparse(target, 1), max_depth),
        colormap_depth(pred, max_depth),
    ]
    return np.concatenate(cols, axis=1)


def add_row(panel: np.ndarray | None, row: np.ndarray) -> np.ndarray:
    return row if panel is None else np.concatenate([panel, row], axis=0)


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no filtering, zlib level
    6)."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PNG of shape {img.shape}: expected (H, W, 3)")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_image(panel: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(panel))


def comparison_panel(prepared: dict, max_rows: int = 4,
                     max_depth: float = 80.0) -> np.ndarray:
    """Batch dict of ``train/step.py::make_predict_fn`` (numpy) -> stacked
    comparison panel."""
    rgb = np.asarray(prepared["rgb"])
    sparse = np.asarray(prepared["radar"])[..., 0]
    target = np.asarray(prepared["target"])[..., 0]
    pred = np.asarray(prepared["pred"])[..., 0]
    panel = None
    for i in range(min(max_rows, rgb.shape[0])):
        panel = add_row(panel, merge_into_row(rgb[i], sparse[i], target[i],
                                              pred[i], max_depth))
    return panel
