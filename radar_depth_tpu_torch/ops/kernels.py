"""The port's hand-written Hopper kernels, their plain PyTorch versions, launch
counters and build loader.

* Kernel A, ``zbuffer_min_depth`` (``csrc/zbuffer.cu``): the min-depth
  z-buffer. Replaces ``radar_depth_tpu/ops/pallas_kernels.py::
  rasterize_min_depth_pallas``.
* Kernel B, ``scale_bias_relu`` (``csrc/epilogue.cu``): the eval-mode BN
  epilogue ``relu(x*scale + bias (+ residual))``. Replaces ``radar_depth_tpu/
  ops/pallas_kernels.py::fused_scale_bias_relu``.

Each wrapper checks its arguments, then runs the plain version for a tensor
on the CPU and launches the CUDA kernel for a tensor on the card; there is no
fallback between the two. Each wrapper counts its launches in a plain integer
attribute (``zbuffer_min_depth.launches``), which a run can reset and read to
show that the main path went through the kernel.

The sources are compiled with ``nvcc`` at first use by a CUDA tensor (or by
``build()``), into ``radar_depth_tpu_torch/_build/`` under a name that carries
a hash of the source, and loaded with ``ctypes``. Nothing is compiled or
loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {"zbuffer": "zbuffer.cu", "epilogue": "epilogue.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------------ build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME as home
    if not home or not (Path(home) / "bin" / "nvcc").is_file():
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME to a CUDA toolkit with bin/nvcc")
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the shared library of source ``name`` is built; the file name
    carries the source's hash, so an edited source is rebuilt."""
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=tuple(SOURCES)) -> dict:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together. Returns {name: seconds} for what was compiled."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    seconds, failed = {}, []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def _library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "zbuffer":
            lib.rdt_zbuffer_min_depth.argtypes = [vp, vp, vp, ci, ci, ci, vp]
            lib.rdt_zbuffer_min_depth.restype = ci
        else:
            lib.rdt_scale_bias_relu.argtypes = [vp, vp, vp, vp, vp, cll, ci,
                                                ci, vp]
            lib.rdt_scale_bias_relu.restype = ci
        _LIBS[name] = lib
    return _LIBS[name]


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


# --------------------------------------------------------- kernel A: z-buffer


def _check_zbuffer(lin, zf):
    if lin.dim() != 2 or lin.shape != zf.shape:
        raise ValueError(f"lin {tuple(lin.shape)} and z {tuple(zf.shape)} must "
                         "both be (B, P)")
    if lin.dtype != torch.int32 or zf.dtype != torch.float32:
        raise TypeError(f"need int32 lin and float32 z, got {lin.dtype}, "
                        f"{zf.dtype}")
    if not (lin.is_contiguous() and zf.is_contiguous()):
        raise ValueError("lin and z must be contiguous")
    if lin.device != zf.device:
        raise ValueError("lin and z must be on one device")


def zbuffer_min_depth_reference(lin: torch.Tensor, zf: torch.Tensor,
                                height: int, width: int) -> torch.Tensor:
    """Plain version of kernel A: a lexicographic (pixel, depth) sort puts each
    pixel's minimum at the head of its run, and the run heads are written
    with unique indices."""
    b = lin.shape[0]
    hw = height * width
    keep = (lin >= 0) & (lin < hw)
    key = (torch.arange(b, device=lin.device)[:, None] * hw + lin.long())[keep]
    val = zf[keep]
    order = torch.argsort(val, stable=True)
    key, val = key[order], val[order]
    order = torch.argsort(key, stable=True)
    key, val = key[order], val[order]
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = key[1:] != key[:-1]
    out = torch.zeros(b * hw, dtype=torch.float32, device=lin.device)
    out[key[head]] = val[head]
    return out.view(b, height, width)


def zbuffer_min_depth(lin: torch.Tensor, zf: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """(B, P) int32 linear pixel indices (-1 = dropped) and float32 depths,
    which must be >= 0 where kept -> (B, H, W) float32 min-depth map, 0 where
    empty. Kernel A on the card, the plain version on the CPU."""
    _check_zbuffer(lin, zf)
    if not _on_card(lin):
        return zbuffer_min_depth_reference(lin, zf, height, width)
    b, p = lin.shape
    out = torch.empty((b, height, width), dtype=torch.float32,
                      device=lin.device)
    lib = _library("zbuffer")
    with torch.cuda.device(lin.device):
        err = lib.rdt_zbuffer_min_depth(
            lin.data_ptr(), zf.data_ptr(), out.data_ptr(), b, p,
            height * width, torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "zbuffer_min_depth")
    zbuffer_min_depth.launches += 1
    return out


zbuffer_min_depth.launches = 0


# ----------------------------------------------------- kernel B: BN epilogue


def _channel_shape(x: torch.Tensor) -> tuple:
    """Broadcast shape of the (C,) parameters for ``x``'s layout: a 4-D
    tensor is NCHW in channels_last memory, any other rank is (..., C)."""
    if x.dim() == 4:
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("a 4-D input must be NCHW in channels_last memory")
        return (1, -1, 1, 1)
    if not x.is_contiguous():
        raise ValueError("a (..., C) input must be contiguous")
    return (-1,)


def _check_epilogue(x, scale, bias, residual) -> int:
    shape = _channel_shape(x)
    c = x.shape[1] if shape == (1, -1, 1, 1) else x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.shape != (c,) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {x.device}")
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device):
            raise ValueError("residual must match x in shape, dtype and "
                             "device")
        _channel_shape(residual)  # same memory order as x, or raise
    return c


def scale_bias_relu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor,
                              residual: torch.Tensor | None = None):
    """Plain version of kernel B: float32 math, one cast to x's dtype."""
    shape = _channel_shape(x)
    y = x.float() * scale.view(shape) + bias.view(shape)
    if residual is not None:
        y = y + residual.float()
    return torch.relu(y).to(x.dtype)


def scale_bias_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(x*scale[c] + bias[c] (+ residual))`` with float32 (C,) scale and
    bias over float32 or bfloat16 ``x`` (NCHW channels_last, or contiguous
    (..., C)). Kernel B on the card, the plain version on the CPU."""
    c = _check_epilogue(x, scale, bias, residual)
    if not _on_card(x):
        return scale_bias_relu_reference(x, scale, bias, residual)
    out = torch.empty_like(x)
    lib = _library("epilogue")
    with torch.cuda.device(x.device):
        err = lib.rdt_scale_bias_relu(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            x.numel(), c, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "scale_bias_relu")
    scale_bias_relu.launches += 1
    return out


scale_bias_relu.launches = 0
