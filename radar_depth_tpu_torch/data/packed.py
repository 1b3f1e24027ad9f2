"""Packed binary shards and the native loader, the port's own copy of
``radar_depth_tpu/data/packed.py``: the same file format and file names, so
shards written by one package are read by the other.

All samples of a split live in one or more fixed-record files (``*.rdtp``:
every record has the schema's shapes, so every record is the same size),
mmap'd by the repo's C++ loader (``native/rdtp_loader.cc``, built as
``native/librdtp.so`` at first use) whose worker threads assemble shuffled,
optionally augmented batches ahead of the consumer. The numpy-memmap reader
is the fallback when the library cannot be built or loaded;
``native_error()`` says why.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import json
import os
import shutil
import struct
import subprocess
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from radar_depth_tpu_torch.data import schema

MAGIC = b"RDTPACK1"
_DTYPES = [np.dtype(np.uint8), np.dtype(np.float32), np.dtype(np.bool_),
           np.dtype(np.int32), np.dtype(np.float64), np.dtype(np.int64)]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_LOCK_DIR = os.path.join(_PKG_DIR, "_build")
# native/Makefile's one rule for librdtp.so, for a machine without make
_CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
              "-Wextra", "-shared", "-lpthread")


def _align64(n: int) -> int:
    return (n + 63) & ~63


def build_header(fields: List[Tuple[str, np.dtype, tuple]], num_samples: int
                 ) -> Tuple[bytes, int, Dict[str, tuple]]:
    """fields [(name, dtype, shape)] -> (header bytes, record_size, layout),
    layout[name] = (offset, nbytes, dtype, shape)."""
    layout = {}
    offset = 0
    body = b""
    for name, dt, shape in fields:
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        nbytes_aligned = (nbytes + 7) & ~7  # 8-byte align each field
        layout[name] = (offset, nbytes, dt, tuple(shape))
        nb = name.encode()
        body += struct.pack("<I", len(nb)) + nb
        body += struct.pack("<I", _DTYPE_CODE[dt])
        body += struct.pack("<I", len(shape))
        for s in shape:
            body += struct.pack("<Q", int(s))
        body += struct.pack("<QQ", offset, nbytes)
        offset += nbytes_aligned
    record_size = _align64(offset)
    header_size = len(MAGIC) + 8 * 3 + 4 + len(body)
    head = MAGIC + struct.pack("<QQQ", header_size, num_samples, record_size)
    head += struct.pack("<I", len(fields)) + body
    assert len(head) == header_size
    return head, record_size, layout


def parse_header(buf: bytes):
    """Header bytes -> (header_size, num_samples, record_size, layout)."""
    assert buf[:8] == MAGIC, "bad magic"
    header_size, num_samples, record_size = struct.unpack_from("<QQQ", buf, 8)
    (num_fields,) = struct.unpack_from("<I", buf, 32)
    off = 36
    layout = {}
    for _ in range(num_fields):
        (nlen,) = struct.unpack_from("<I", buf, off); off += 4
        name = buf[off: off + nlen].decode(); off += nlen
        (code,) = struct.unpack_from("<I", buf, off); off += 4
        (ndim,) = struct.unpack_from("<I", buf, off); off += 4
        shape = struct.unpack_from(f"<{ndim}Q", buf, off); off += 8 * ndim
        foff, fbytes = struct.unpack_from("<QQ", buf, off); off += 16
        layout[name] = (foff, fbytes, _DTYPES[code],
                        tuple(int(s) for s in shape))
    return header_size, num_samples, record_size, layout


class _ShardFileWriter:
    """Streams records of one shard file to disk (memory bounded by one
    record). The header goes first with a num_samples placeholder that
    ``close`` patches in place."""

    def __init__(self, path: str, fields):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        head, self.record_size, self.layout = build_header(fields, 0)
        self._f = open(path, "wb")
        self._f.write(head)
        self._f.write(b"\0" * (_align64(len(head)) - len(head)))
        self._rec = bytearray(self.record_size)
        self.num_samples = 0

    def write(self, sample) -> None:
        rec = self._rec
        rec[:] = b"\0" * self.record_size
        for k, (off, nbytes, dt, shape) in self.layout.items():
            arr = np.ascontiguousarray(np.asarray(sample[k], dtype=dt))
            assert arr.shape == shape, (k, arr.shape, shape)
            rec[off: off + nbytes] = arr.tobytes()
        self._f.write(rec)
        self.num_samples += 1

    def close(self) -> None:
        assert self.num_samples, f"empty shard: {self.path}"
        self._f.seek(len(MAGIC) + 8)  # num_samples slot in the fixed header
        self._f.write(struct.pack("<Q", self.num_samples))
        self._f.close()


def _fields_of(sample):
    return [(k, np.asarray(sample[k]).dtype, tuple(np.asarray(sample[k]).shape))
            for k in schema.SAMPLE_KEYS]


def _write_sidecar(path: str, tags) -> None:
    # written after the shard; a tag-less rewrite removes a stale sidecar,
    # which would otherwise mislabel every sample
    sidecar = path + ".tags.json"
    if tags is not None:
        with open(sidecar, "w") as f:
            json.dump(tags, f)
    elif os.path.exists(sidecar):
        os.remove(sidecar)


def write_shard(path: str, samples, spec: Optional[schema.SampleSpec] = None,
                tags=None) -> None:
    """Stream an iterable of schema samples into one shard file. ``tags``:
    optional per-sample split tags (day/night), stored in a
    ``<shard>.tags.json`` sidecar."""
    it = iter(samples)
    first = next(it, None)
    assert first is not None, "empty shard"
    w = _ShardFileWriter(path, _fields_of(first))
    w.write(first)
    for s in it:
        w.write(s)
    w.close()
    if tags is not None:
        tags = list(tags)
        assert len(tags) == w.num_samples, (len(tags), w.num_samples)
    _write_sidecar(path, tags)


def write_shards(dir_path: str, samples,
                 spec: Optional[schema.SampleSpec] = None, tags=None,
                 max_shard_bytes: int = 2 << 30, basename: str = "data"
                 ) -> List[str]:
    """Stream samples into ``dir_path/<basename>-NNNNN.rdtp`` files, rolling
    to a new one when the current one reaches ``max_shard_bytes``; each shard
    gets the aligned slice of ``tags`` as its sidecar. Returns the paths
    (``PackedDataset`` opens the directory)."""
    tag_it = iter(tags) if tags is not None else None
    paths: List[str] = []
    writer = None
    fields = None
    per_shard = 0
    shard_tags: List = []

    def roll():
        writer.close()
        _write_sidecar(writer.path,
                       shard_tags[:] if tag_it is not None else None)
        shard_tags.clear()

    for sample in samples:
        if writer is None:
            if fields is None:
                fields = _fields_of(sample)
            path = os.path.join(dir_path, f"{basename}-{len(paths):05d}.rdtp")
            writer = _ShardFileWriter(path, fields)
            paths.append(path)
            per_shard = max(1, int(max_shard_bytes) // writer.record_size)
        writer.write(sample)
        if tag_it is not None:
            t = next(tag_it, None)
            assert t is not None, "fewer tags than samples"
            shard_tags.append(t)
        if writer.num_samples >= per_shard:
            roll()
            writer = None
    if writer is not None:
        roll()
    assert paths, "empty split"
    if tag_it is not None:
        assert next(tag_it, None) is None, "more tags than samples"
    return paths


# ---------------------------------------------------------------- native lib

_lib = None
_lib_error: Optional[str] = None


def _build_native(so: str) -> None:
    """``make -C native``, or the Makefile's g++ line where make is missing,
    under a file lock so that processes starting together build once."""
    os.makedirs(_LOCK_DIR, exist_ok=True)
    with open(os.path.join(_LOCK_DIR, "librdtp.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return
        if shutil.which("make"):
            subprocess.run(["make", "-C", NATIVE_DIR, "-s"], check=True,
                           capture_output=True, timeout=300)
            return
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run([os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o", tmp,
                        os.path.join(NATIVE_DIR, "rdtp_loader.cc")],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    so = os.path.join(NATIVE_DIR, "librdtp.so")
    try:
        if not os.path.exists(so):
            _build_native(so)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        _lib_error = f"{type(e).__name__}: {e} {detail[-500:]!r}"
        return None
    lib.rdtp_open.restype = ctypes.c_void_p
    lib.rdtp_open.argtypes = [ctypes.c_char_p]
    lib.rdtp_open_multi.restype = ctypes.c_void_p
    lib.rdtp_open_multi.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.c_uint64]
    lib.rdtp_num_samples.restype = ctypes.c_uint64
    lib.rdtp_num_samples.argtypes = [ctypes.c_void_p]
    lib.rdtp_record_size.restype = ctypes.c_uint64
    lib.rdtp_record_size.argtypes = [ctypes.c_void_p]
    lib.rdtp_header_size.restype = ctypes.c_uint64
    lib.rdtp_header_size.argtypes = [ctypes.c_void_p]
    lib.rdtp_read_header.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rdtp_gather.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.c_uint64, ctypes.c_char_p]
    lib.rdtp_close.argtypes = [ctypes.c_void_p]
    lib.rdtp_loader_create.restype = ctypes.c_void_p
    lib.rdtp_loader_create.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_int, ctypes.c_uint64,
                                       ctypes.c_uint64, ctypes.c_uint64]
    lib.rdtp_loader_next.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rdtp_loader_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.POINTER(ctypes.c_uint64)]
    lib.rdtp_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.rdtp_loader_set_augment.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(NativeAugSpec)]
    lib.rdtp_loader_start.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    _lib, _lib_error = lib, None
    return lib


def native_available() -> bool:
    return _load_native() is not None


def native_error() -> Optional[str]:
    """Why the native library could not be built or loaded, or None."""
    return None if native_available() else _lib_error


class NativeAugSpec(ctypes.Structure):
    """Mirror of ``rdtp_loader.cc::AugSpec`` (worker-side augmentation)."""

    _fields_ = [
        ("image_off", ctypes.c_uint64),
        ("lidar_depth_off", ctypes.c_uint64),
        ("lidar_points_off", ctypes.c_uint64),
        ("radar_tf_off", ctypes.c_uint64),
        ("intrinsics_off", ctypes.c_uint64),
        ("height", ctypes.c_uint64),
        ("width", ctypes.c_uint64),
        ("lidar_points", ctypes.c_uint64),
        ("num_sweeps", ctypes.c_uint64),
        ("scale_min", ctypes.c_float),
        ("scale_max", ctypes.c_float),
        ("rot_deg", ctypes.c_float),
        ("hflip_prob", ctypes.c_float),
        ("jitter", ctypes.c_float),
        ("seed", ctypes.c_uint64),
    ]


def build_aug_spec(layout: Dict[str, tuple], augment_cfg, seed: int
                   ) -> NativeAugSpec:
    """Field offsets of a shard layout + AugmentConfig -> AugSpec."""
    h, w, _ = layout["image"][3]
    return NativeAugSpec(
        image_off=layout["image"][0],
        lidar_depth_off=layout["lidar_depth"][0],
        lidar_points_off=layout["lidar_points"][0],
        radar_tf_off=layout["radar_transform"][0],
        intrinsics_off=layout["intrinsics"][0],
        height=h, width=w,
        lidar_points=layout["lidar_points"][3][0],
        num_sweeps=layout["radar_transform"][3][0],
        scale_min=augment_cfg.scale_range[0],
        scale_max=augment_cfg.scale_range[1],
        rot_deg=augment_cfg.rotation_deg,
        hflip_prob=augment_cfg.hflip_prob,
        jitter=augment_cfg.jitter,
        seed=seed,
    )


def _read_header_file(path: str):
    with open(path, "rb") as f:
        head = f.read(16 * 4096)
        declared = int(np.frombuffer(head[8:16], np.uint64)[0])
        if declared > len(head):  # a header larger than the first read
            f.seek(0)
            head = f.read(declared)
    return parse_header(head)


class PackedDataset:
    """Random-access reader over one split: a ``data.rdtp`` file or a
    directory of ``*.rdtp`` shards (native mmap when the library loads,
    numpy memmap otherwise). Has ``SyntheticNuScenes``'s ``batch()`` API;
    indices are global across shards."""

    def __init__(self, path: str, use_native: Optional[bool] = None):
        if os.path.isdir(path):
            single = os.path.join(path, "data.rdtp")
            if os.path.exists(single):
                paths = [single]
            else:
                paths = sorted(glob.glob(os.path.join(path, "*.rdtp")))
                if not paths:
                    raise IOError(f"no .rdtp shards in {path}")
        else:
            paths = [path]
        self.paths = paths
        self.path = paths[0]
        # every shard of a split must share the whole field table
        headers = [_read_header_file(p) for p in paths]
        (self._header_size, _, self._record_size, self.layout) = headers[0]
        for p, h in zip(paths[1:], headers[1:]):
            if h[2] != self._record_size or h[3] != self.layout:
                raise IOError(
                    f"{p}: record layout differs from {paths[0]} — shards of "
                    "a split must be written with the same schema")
        self._counts = [h[1] for h in headers]
        self._n = int(sum(self._counts))
        lib = _load_native() if use_native in (None, True) else None
        if use_native is True and lib is None:
            raise RuntimeError(f"native librdtp unavailable: {_lib_error}")
        self._lib = lib
        if lib is not None:
            arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
            self._h = lib.rdtp_open_multi(arr, len(paths))
            if not self._h:
                raise IOError(f"rdtp_open_multi failed: {paths}")
        else:
            self._mms = [np.memmap(p, dtype=np.uint8, mode="r") for p in paths]
            self._offs = [_align64(h[0]) for h in headers]
            self._cum = np.concatenate(
                [[0], np.cumsum(self._counts)]).astype(np.int64)

    def __len__(self) -> int:
        return self._n

    @property
    def native(self) -> bool:
        return self._lib is not None

    @property
    def tags(self):
        """Per-sample split tags from the shards' sidecars, or None when a
        shard has none (or a stale one)."""
        if not hasattr(self, "_tags"):
            self._tags = None
            all_t = []
            for p, n in zip(self.paths, self._counts):
                sidecar = p + ".tags.json"
                if not os.path.exists(sidecar):
                    return None
                with open(sidecar) as f:
                    t = json.load(f)
                if len(t) != n:
                    warnings.warn(
                        f"{sidecar}: {len(t)} tags != {n} samples — "
                        "ignoring stale sidecar (rewrite the shard with "
                        "write_shard(tags=...))")
                    return None
                all_t.extend(t)
            self._tags = all_t
        return self._tags

    def sample_tag(self, index: int) -> str:
        t = self.tags
        return t[int(index)] if t is not None else "all"

    def _unpack(self, raw: np.ndarray, batch: int) -> Dict[str, np.ndarray]:
        out = {}
        raw = raw.reshape(batch, self._record_size)
        for k, (off, nbytes, dt, shape) in self.layout.items():
            # a copy: the native buffers are reused by the next gather
            arrs = raw[:, off: off + nbytes].copy()
            out[k] = arrs.view(dt).reshape((batch,) + shape)
        return out

    def batch(self, indices) -> Dict[str, np.ndarray]:
        idx = np.asarray(list(indices), dtype=np.uint64)
        b = len(idx)
        if self._lib is not None:
            out = np.empty(b * self._record_size, np.uint8)
            self._lib.rdtp_gather(
                self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                b, out.ctypes.data_as(ctypes.c_char_p))
        else:
            out = np.empty((b, self._record_size), np.uint8)
            rs = self._record_size
            for i, j in enumerate(idx.astype(np.int64)):
                si = int(np.searchsorted(self._cum, j, side="right")) - 1
                start = self._offs[si] + int(j - self._cum[si]) * rs
                out[i] = self._mms[si][start: start + rs]
            out = out.reshape(-1)
        return self._unpack(out, b)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        b = self.batch([i])
        return {k: v[0] for k, v in b.items()}

    def close(self):
        if self._lib is not None and self._h:
            self._lib.rdtp_close(self._h)
            self._h = None


class NativeBatchLoader:
    """Prefetching batch iterator over the C++ thread pool: the
    DataLoader(num_workers) equivalent. Infinite; ``.epoch`` tells the
    loader's epoch of the last batch. Batches arrive in claim order, so the
    stream depends on the seed only, not on the thread count."""

    def __init__(self, dataset: PackedDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, queue_depth: int = 4,
                 threads: int = 2, augment=None):
        """``augment``: an AugmentConfig; when enabled the workers apply the
        reference's train transforms per sample on the host (scale, rotate,
        flip, jitter, geometry folded into the intrinsics and transforms),
        and the batches then take the eval preprocessing on the device."""
        if dataset._lib is None:
            raise RuntimeError("NativeBatchLoader requires librdtp")
        if not 0 < batch_size <= len(dataset):
            raise ValueError(
                f"batch_size {batch_size} must be in [1, {len(dataset)}] "
                "(the native loader drops ragged tails)")
        self.ds = dataset
        self.batch_size = batch_size
        self._lib = dataset._lib
        # created paused, augmentation set, then started: no prefetch races
        # the configuration
        self._L = self._lib.rdtp_loader_create(
            dataset._h, batch_size, int(shuffle), seed, queue_depth, 0)
        if not self._L:
            raise RuntimeError("rdtp_loader_create failed")
        if augment is not None and augment.enabled:
            spec = build_aug_spec(dataset.layout, augment, seed)
            self._lib.rdtp_loader_set_augment(self._L, ctypes.byref(spec))
        self._lib.rdtp_loader_start(self._L, max(1, threads))
        self.epoch = 0
        self.index_in_epoch = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        ep = ctypes.c_uint64()
        ix = ctypes.c_uint64()
        ptr = self._lib.rdtp_loader_next(self._L, ctypes.byref(ep),
                                         ctypes.byref(ix))
        if not ptr:
            raise StopIteration
        self.epoch, self.index_in_epoch = ep.value, ix.value
        n = self.batch_size * self.ds._record_size
        raw = np.ctypeslib.as_array(ptr, shape=(n,))
        return self.ds._unpack(raw, self.batch_size)

    def close(self):
        if self._L:
            self._lib.rdtp_loader_destroy(self._L)
            self._L = None
