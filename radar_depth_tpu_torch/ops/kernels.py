"""The port's hand-written Hopper kernels, their plain PyTorch versions, launch
counters and build loader.

* Kernel A, ``zbuffer_min_depth`` (``csrc/zbuffer.cu``): the min-depth
  z-buffer. Replaces ``radar_depth_tpu/ops/pallas_kernels.py::
  rasterize_min_depth_pallas``.
* Kernel B (``csrc/epilogue.cu``): the eval-mode BN epilogue ``relu(x*scale
  + bias (+ residual))``, as ``scale_bias_relu`` (the folded scale and bias
  given) and as ``batch_norm_relu`` (the BN's own parameters and running
  statistics, folded inside the kernel). Replaces ``radar_depth_tpu/ops/
  pallas_kernels.py::fused_scale_bias_relu``.
* Kernel C, ``zbuffer_min_depth_sorted`` (``csrc/zbuffer_sorted.cu``): the
  min-depth z-buffer over points sorted by pixel. Replaces ``radar_depth_tpu/
  ops/pallas_kernels.py::rasterize_min_depth_pallas_sorted``.
* Kernel D (``csrc/bn_train.cu``): the train-mode BatchNorm (+ residual)
  (+ ReLU) and its backward, as four calls, ``bn_stats``, ``bn_apply``,
  ``bn_grad_stats`` and ``bn_grad_input``, joined into two autograd nodes by
  ``bn_train_moments`` and ``bn_train_apply`` (the model's path). Replaces
  no TPU kernel: flax's BatchNorm is plain XLA in the JAX package.

Kernels A, B and C are registered torch operators, ``torch.ops.rdt.
zbuffer_min_depth``, ``rdt.zbuffer_min_depth_sorted``, ``rdt.scale_bias_relu``
and ``rdt.batch_norm_relu``, so that a tracer (``torch.export``) keeps each
as one node of its graph; kernel D runs in training only, which nothing
exports, and its wrappers call ctypes directly. Each operator has three
implementations: the CUDA launch, the plain version for the CPU, and a fake
one that gives the output's shape, dtype, device and memory format to the
tracer. No other device has one, so a tensor elsewhere raises. Each wrapper
checks its arguments, then calls its operator (kernel D: its launch, or its
plain version for a CPU tensor); there is no fallback between the CPU and
the card. The CUDA implementation counts its launches in a plain integer
attribute of the kernel's wrapper (``zbuffer_min_depth.launches``; kernel
B's two operators both in ``scale_bias_relu.launches``; kernel D's four
calls each in its own, ``bn_stats.launches`` and so on, a call with a
partial pass and a combine counted once), which a run can reset and read to
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
SOURCES = {"zbuffer": "zbuffer.cu", "epilogue": "epilogue.cu",
           "zbuffer_sorted": "zbuffer_sorted.cu", "bn_train": "bn_train.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The operators; their implementations are registered beside each kernel.
OPS = torch.library.Library("rdt", "DEF")
OPS.define("zbuffer_min_depth(Tensor lin, Tensor z, int height, int width) "
           "-> Tensor")
OPS.define("zbuffer_min_depth_sorted(Tensor lin_sorted, Tensor z_sorted, "
           "int height, int width) -> Tensor")
OPS.define("scale_bias_relu(Tensor x, Tensor scale, Tensor bias, "
           "Tensor? residual=None) -> Tensor")
OPS.define("batch_norm_relu(Tensor x, Tensor weight, Tensor bias, "
           "Tensor running_mean, Tensor running_var, float eps, "
           "Tensor? residual=None) -> Tensor")


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
    all started together. Returns {name: {"seconds": s, "ptxas": [...]}} for
    what was compiled, "ptxas" holding ptxas's lines on each kernel's
    registers, shared memory and spills."""
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
    built, failed = {}, []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        built[n] = {"seconds": time.perf_counter() - t0,
                    "ptxas": [line.strip() for line in log.splitlines()
                              if line.startswith("ptxas info")
                              or "bytes spill" in line]}
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return built


def _library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        zbuffer_args = [vp, vp, vp, ci, ci, ci, vp]
        cf = ctypes.c_float
        fns = {
            "zbuffer": {"rdt_zbuffer_min_depth": zbuffer_args},
            "zbuffer_sorted": {"rdt_zbuffer_min_depth_sorted": zbuffer_args},
            "epilogue": {"rdt_scale_bias_relu":
                         [vp, vp, vp, vp, vp, vp, vp, cf, cll, ci, ci, vp]},
            "bn_train": {
                "rdt_bnt_stats": [vp, vp, vp, vp, cll, ci, ci, ci, ci, cll,
                                  ci, vp],
                "rdt_bnt_apply": [vp, vp, vp, vp, vp, vp, vp, vp, vp, cf, cf,
                                  cf, cll, ci, ci, ci, ci, vp],
                "rdt_bnt_grad_stats": [vp, vp, vp, vp, vp, vp, vp, cf, vp, vp,
                                       vp, vp, vp, cll, ci, ci, ci, ci, ci,
                                       cll, ci, vp],
                "rdt_bnt_grad_input": [vp, vp, vp, vp, vp, vp, vp, cf, vp, vp,
                                       cll, ci, ci, ci, ci, vp]},
        }[name]
        for fn, args in fns.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ci
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
    empty. Kernel A on the card, the plain version on the CPU
    (``torch.ops.rdt.zbuffer_min_depth``).

    The kernel's map is bit-equal to the plain version's, except where a
    kept depth of exactly +0.0 is a pixel's minimum: the kernel writes -0.0
    there (its empty pixel has the bits of +0.0), which equals the plain
    version's +0.0 as a float (``torch.equal``). ``bin_points`` keeps only
    depths > min_depth >= 0, so the main path never hits that case."""
    _check_zbuffer(lin, zf)
    _on_card(lin)
    return torch.ops.rdt.zbuffer_min_depth(lin, zf, height, width)


def _zbuffer_min_depth_cuda(lin, zf, height, width):
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


def _zbuffer_fake(lin, zf, height, width):
    return lin.new_empty((lin.shape[0], height, width), dtype=torch.float32)


OPS.impl("zbuffer_min_depth", _zbuffer_min_depth_cuda, "CUDA")
OPS.impl("zbuffer_min_depth", zbuffer_min_depth_reference, "CPU")
torch.library.register_fake("rdt::zbuffer_min_depth", _zbuffer_fake, lib=OPS)
zbuffer_min_depth.launches = 0


# ------------------------------------------------ kernel C: sorted z-buffer

SORTED_INVALID = 1 << 30  # sentinel pixel index of a dropped point
_GRID_Y_MAX = 65535


def zbuffer_min_depth_sorted_reference(lin_sorted: torch.Tensor,
                                       z_sorted: torch.Tensor, height: int,
                                       width: int) -> torch.Tensor:
    """Plain version of kernel C. The map is the same function of the points
    as kernel A's, whatever their order, so this is kernel A's plain version:
    the sentinel lies outside the image and is dropped like -1."""
    return zbuffer_min_depth_reference(lin_sorted, z_sorted, height, width)


def zbuffer_min_depth_sorted(lin_sorted: torch.Tensor, z_sorted: torch.Tensor,
                             height: int, width: int) -> torch.Tensor:
    """(B, P) int32 linear pixel indices, ascending along each row, with
    ``SORTED_INVALID`` for dropped points, and float32 depths in the same
    order, which must be >= 0 where kept -> (B, H, W) float32 min-depth map,
    0 where empty. Kernel C on the card, the plain version on the CPU
    (``torch.ops.rdt.zbuffer_min_depth_sorted``).

    The rows must be sorted (``ops/raster.py::sort_points_by_pixel``); the
    kernel does not check it, as the TPU kernel does not."""
    _check_zbuffer(lin_sorted, z_sorted)
    hw = height * width
    if not 0 < hw < SORTED_INVALID:
        raise ValueError(f"height*width={hw} must be in (0, 2**30)")
    if _on_card(lin_sorted) and lin_sorted.shape[0] > _GRID_Y_MAX:
        raise ValueError(f"batch {lin_sorted.shape[0]} > {_GRID_Y_MAX}: "
                         "split the call")
    return torch.ops.rdt.zbuffer_min_depth_sorted(lin_sorted, z_sorted, height,
                                                  width)


def _zbuffer_min_depth_sorted_cuda(lin_sorted, z_sorted, height, width):
    b, p = lin_sorted.shape
    out = torch.empty((b, height, width), dtype=torch.float32,
                      device=lin_sorted.device)
    if b == 0:
        return out
    lib = _library("zbuffer_sorted")
    with torch.cuda.device(lin_sorted.device):
        err = lib.rdt_zbuffer_min_depth_sorted(
            lin_sorted.data_ptr(), z_sorted.data_ptr(), out.data_ptr(), b, p,
            height * width, torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "zbuffer_min_depth_sorted")
    zbuffer_min_depth_sorted.launches += 1
    return out


OPS.impl("zbuffer_min_depth_sorted", _zbuffer_min_depth_sorted_cuda, "CUDA")
OPS.impl("zbuffer_min_depth_sorted", zbuffer_min_depth_sorted_reference,
         "CPU")
torch.library.register_fake("rdt::zbuffer_min_depth_sorted", _zbuffer_fake,
                            lib=OPS)
zbuffer_min_depth_sorted.launches = 0


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


def _check_epilogue(x, params: dict, residual) -> None:
    """Raise unless kernel B takes ``x``, the (C,) float32 ``params``
    (name -> tensor) and ``residual``."""
    shape = _channel_shape(x)
    c = x.shape[1] if shape == (1, -1, 1, 1) else x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in params.items():
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


def fold_batch_norm(weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    eps: float) -> tuple:
    """An eval-mode BN's float32 (scale, bias): ``weight/sqrt(var+eps)`` and
    ``bias - mean*scale``, in the order kernel B folds them."""
    scale = weight * torch.rsqrt(running_var + eps)
    return scale, bias - running_mean * scale


def scale_bias_relu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor,
                              residual: torch.Tensor | None = None):
    """Plain version of kernel B: float32 math, one cast to x's dtype."""
    shape = _channel_shape(x)
    y = x.float() * scale.view(shape) + bias.view(shape)
    if residual is not None:
        y = y + residual.float()
    return torch.relu(y).to(x.dtype)


def batch_norm_relu_reference(x, weight, bias, running_mean, running_var,
                              eps: float, residual=None):
    """Plain version of kernel B with the fold: ``fold_batch_norm`` then
    ``scale_bias_relu_reference``."""
    return scale_bias_relu_reference(
        x, *fold_batch_norm(weight, bias, running_mean, running_var, eps),
        residual)


def scale_bias_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(x*scale[c] + bias[c] (+ residual))`` with float32 (C,) scale and
    bias over float32 or bfloat16 ``x`` (NCHW channels_last, or contiguous
    (..., C)). Kernel B on the card, the plain version on the CPU
    (``torch.ops.rdt.scale_bias_relu``)."""
    _check_epilogue(x, {"scale": scale, "bias": bias}, residual)
    _on_card(x)
    return torch.ops.rdt.scale_bias_relu(x, scale, bias, residual)


def batch_norm_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    eps: float,
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """Eval-mode BN, ``(+ residual)``, ReLU: ``scale_bias_relu`` of the BN's
    float32 (C,) weight, bias and running statistics folded with ``eps``
    (``fold_batch_norm``), the fold done inside kernel B's one launch on the
    card, the plain version on the CPU (``torch.ops.rdt.batch_norm_relu``).
    Its launches count in ``scale_bias_relu.launches``."""
    _check_epilogue(x, {"weight": weight, "bias": bias,
                        "running_mean": running_mean,
                        "running_var": running_var}, residual)
    _on_card(x)
    return torch.ops.rdt.batch_norm_relu(x, weight, bias, running_mean,
                                         running_var, eps, residual)


def launch_epilogue(x, residual, out, p0, p1, running_mean=None,
                    running_var=None, eps: float = 0.0) -> None:
    """Kernel B's bare launch into ``out``, unchecked and uncounted: the
    CUDA implementations' body. ``p0, p1`` are the folded scale and bias,
    or, with the running statistics given, the BN's weight and bias, folded
    in the kernel with ``eps``. One ctypes call on x's device and current
    stream; the device is switched only when x's is not the current one."""
    fn = _library("epilogue").rdt_scale_bias_relu
    index = x.device.index
    args = (x.data_ptr(), None if residual is None else residual.data_ptr(),
            out.data_ptr(), p0.data_ptr(), p1.data_ptr(),
            None if running_mean is None else running_mean.data_ptr(),
            None if running_var is None else running_var.data_ptr(), eps,
            x.numel(), p0.shape[0], _DTYPE_CODE[x.dtype],
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    _check_launch(err, "kernel B")


def _scale_bias_relu_cuda(x, scale, bias, residual=None):
    out = torch.empty_like(x)
    if x.numel():
        launch_epilogue(x, residual, out, scale, bias)
        scale_bias_relu.launches += 1
    return out


def _batch_norm_relu_cuda(x, weight, bias, running_mean, running_var, eps,
                          residual=None):
    out = torch.empty_like(x)
    if x.numel():
        launch_epilogue(x, residual, out, weight, bias, running_mean,
                        running_var, eps)
        scale_bias_relu.launches += 1
    return out


def _epilogue_fake(x, *args):
    return torch.empty_like(x)  # the same memory format: channels_last


OPS.impl("scale_bias_relu", _scale_bias_relu_cuda, "CUDA")
OPS.impl("scale_bias_relu", scale_bias_relu_reference, "CPU")
torch.library.register_fake("rdt::scale_bias_relu", _epilogue_fake, lib=OPS)
OPS.impl("batch_norm_relu", _batch_norm_relu_cuda, "CUDA")
OPS.impl("batch_norm_relu", batch_norm_relu_reference, "CPU")
torch.library.register_fake("rdt::batch_norm_relu", _epilogue_fake, lib=OPS)
# both operators launch kernel B, and count here
scale_bias_relu.launches = 0


# ------------------------------------------- kernel D: train-mode BatchNorm

_REDUCE_THREADS = 256
_REDUCE_BLOCKS_PER_SM = 4  # the reducing passes' grid target, per SM
_REDUCE_MIN_ROWS = 4  # rows per thread at least, in a chunk
_SMS: dict = {}


def bn_reduce_plan(rows: int, groups: int, sms: int) -> tuple:
    """Kernel D's reducing passes over ``rows`` rows of ``groups`` vector
    columns on ``sms`` SMs: (tx, chunk_rows, chunks). A block is tx columns
    (a power of two up to 32) by 256 // tx rows; the row chunks make about
    4 blocks per SM with the column tiles, each thread folding at least 4
    rows. A function of the shape and the card alone, so a shape's sums
    take the same order on every run."""
    tx = min(32, 1 << max(groups - 1, 0).bit_length())
    ty = _REDUCE_THREADS // tx
    col_tiles = -(-groups // tx)
    want = max(1, sms * _REDUCE_BLOCKS_PER_SM // col_tiles)
    chunk_rows = -(-rows // want)
    chunk_rows = max(-(-chunk_rows // ty) * ty, ty * _REDUCE_MIN_ROWS)
    return tx, chunk_rows, -(-rows // chunk_rows)


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _float_type(x: torch.Tensor) -> torch.dtype:
    """The statistics' and the math's dtype: float32, or float64 for a
    float64 ``x`` (the plain versions only)."""
    return torch.promote_types(x.dtype, torch.float32)


def _check_bn_x(x: torch.Tensor, *others) -> None:
    """Raise unless kernel D takes ``x`` (NCHW, channels_last, float32 or
    bfloat16, not empty) and ``others`` (None, or x's shape, dtype, device
    and memory format). The plain versions take any NCHW tensor."""
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("kernel D takes NCHW tensors in channels_last memory")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel D takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("kernel D takes no empty tensor")
    for t in others:
        if t is not None and (
                t.shape != x.shape or t.dtype != x.dtype
                or t.device != x.device
                or not t.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError("every tensor of kernel D must match x in shape, "
                             "dtype, device and channels_last memory")


def _check_bn_params(x: torch.Tensor, **params) -> None:
    c = x.shape[1]
    for name, t in params.items():
        if (t.shape != (c,) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {x.device}")


def _lanes(x: torch.Tensor, *others) -> int:
    """16 bytes of x's dtype when C divides by it and every pointer is
    16-byte aligned, else 1."""
    v = 16 // x.element_size()
    if x.shape[1] % v:
        return 1
    ptrs = [t.data_ptr() for t in (x, *others) if t is not None]
    return v if all(p % 16 == 0 for p in ptrs) else 1


def _launch_d(name: str, x: torch.Tensor, *args) -> None:
    """One kernel D entry point on x's device and current stream."""
    fn = getattr(_library("bn_train"), name)
    index = x.device.index
    args = (*args, torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    _check_launch(err, f"kernel D ({name})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[1]


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def bn_stats_reference(x: torch.Tensor) -> tuple:
    """Plain version of kernel D's statistics: (mean, biased variance) over
    (N, H, W) in float32 (float64 for float64 x), torch's two-pass
    ``var_mean``."""
    var, mean = torch.var_mean(x.to(_float_type(x)), dim=(0, 2, 3),
                               correction=0)
    return mean, var


def bn_stats(x: torch.Tensor) -> tuple:
    """Per-channel (mean, biased variance) of an NCHW channels_last float32
    or bfloat16 ``x`` over (N, H, W), float32 (C,) each. Kernel D's
    statistics pass on the card (a partial pass and a combine, counted as
    one launch), the plain version on the CPU. Deterministic on the card:
    per-thread Welford, then Chan's combine in a fixed order; within float
    rounding of ``torch.var_mean``."""
    if not _on_card(x):
        return bn_stats_reference(x)
    _check_bn_x(x)
    c, rows = x.shape[1], _rows(x)
    lanes = _lanes(x)
    tx, chunk_rows, chunks = bn_reduce_plan(rows, c // lanes,
                                            _sm_count(x.device))
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    part = torch.empty((2, chunks, c), dtype=torch.float32, device=x.device)
    _launch_d("rdt_bnt_stats", x, x.data_ptr(), part.data_ptr(),
              out[0].data_ptr(), out[1].data_ptr(), rows, c,
              _DTYPE_CODE[x.dtype], lanes, tx, chunk_rows, chunks)
    bn_stats.launches += 1
    return out[0], out[1]


def bn_apply_reference(x, mean, var, weight, bias, eps: float,
                       residual=None, relu: bool = False, running=None):
    """Plain version of kernel D's apply: ``relu?(((x - mean) * (rsqrt(var +
    eps) * weight) + bias).to(x.dtype) (+ residual))``, the math in float32
    (float64 for float64 x), the residual added in x's dtype. ``running``
    (running_mean, running_var, momentum) moves the buffers in place to
    ``momentum * running + (1 - momentum) * batch``."""
    if running is not None:
        rm, rv, m = running
        with torch.no_grad():
            rm.copy_(m * rm + (1 - m) * mean)
            rv.copy_(m * rv + (1 - m) * var)
    mul = torch.rsqrt(var + eps) * weight
    y = ((x.to(_float_type(x)) - _per_channel(mean)) * _per_channel(mul)
         + _per_channel(bias)).to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def bn_apply(x, mean, var, weight, bias, eps: float, residual=None,
             relu: bool = False, running=None) -> torch.Tensor:
    """Train-mode BN's normalization of an NCHW channels_last float32 or
    bfloat16 ``x`` with the given float32 (C,) batch statistics, weight and
    bias, ``(+ residual)``, ``(ReLU)``, and the running update (see
    ``bn_apply_reference``). Kernel D's apply on the card, bit-equal to the
    plain version given the same statistics; the plain version on the
    CPU."""
    if not _on_card(x):
        return bn_apply_reference(x, mean, var, weight, bias, eps, residual,
                                  relu, running)
    _check_bn_x(x, residual)
    rm = rv = None
    keep = fresh = 0.0
    if running is not None:
        rm, rv, m = running
        keep, fresh = m, 1 - m
        _check_bn_params(x, running_mean=rm, running_var=rv)
    _check_bn_params(x, mean=mean, var=var, weight=weight, bias=bias)
    out = torch.empty_like(x)
    _launch_d("rdt_bnt_apply", x, x.data_ptr(), _ptr(residual),
              out.data_ptr(), mean.data_ptr(), var.data_ptr(),
              weight.data_ptr(), bias.data_ptr(), _ptr(rm), _ptr(rv), eps,
              keep, fresh, _rows(x), x.shape[1], _DTYPE_CODE[x.dtype],
              _lanes(x, residual, out), int(relu))
    bn_apply.launches += 1
    return out


def _relu_grad(dy, y):
    """torch.relu's backward: 0 where the output is <= 0."""
    return dy.masked_fill(y <= 0, 0)


def bn_grad_stats_reference(dy, y, x, mean, var, weight, eps: float,
                            relu: bool = False, residual: bool = False):
    """Plain version of kernel D's gradient sums: with dy' = dy masked by
    ``y > 0`` under the ReLU, S1 = sum dy' and S2 = sum dy' * (x - mean)
    over (N, H, W) in float32, then ``(dres, dweight, dbias, dmean, dvar)``:
    dres = dy' if ``residual`` else None, dbias = S1, dweight = S2 * r,
    dvar = -0.5 * S2 * weight * r**3, dmean = -(r * weight) * S1, with r =
    rsqrt(var + eps)."""
    da = _relu_grad(dy, y) if relu else dy
    ft = _float_type(x)
    daf = da.to(ft)
    s1 = daf.sum((0, 2, 3))
    s2 = (daf * (x.to(ft) - _per_channel(mean))).sum((0, 2, 3))
    r = torch.rsqrt(var + eps)
    dvar = s2 * weight * -0.5 * (r * r * r)
    return (da if residual else None), s2 * r, s1, -(r * weight) * s1, dvar


def bn_grad_stats(dy, y, x, mean, var, weight, eps: float, relu: bool = False,
                  residual: bool = False) -> tuple:
    """The per-channel part of kernel D's backward (see
    ``bn_grad_stats_reference``): one reducing pass over dy, y (under the
    ReLU) and x that also writes dres, and a combine, counted as one
    launch; deterministic like ``bn_stats``. The plain version on the
    CPU."""
    if not _on_card(x):
        return bn_grad_stats_reference(dy, y, x, mean, var, weight, eps, relu,
                                       residual)
    _check_bn_x(x, dy, y if relu else None)
    _check_bn_params(x, mean=mean, var=var, weight=weight)
    c, rows = x.shape[1], _rows(x)
    dres = torch.empty_like(x) if residual else None
    yy = y if relu else None
    lanes = _lanes(x, dy, yy, dres)
    tx, chunk_rows, chunks = bn_reduce_plan(rows, c // lanes,
                                            _sm_count(x.device))
    out = torch.empty((4, c), dtype=torch.float32, device=x.device)
    part = torch.empty((2, chunks, c), dtype=torch.float32, device=x.device)
    dweight, dbias, dmean, dvar = out.unbind(0)
    _launch_d("rdt_bnt_grad_stats", x, dy.data_ptr(), _ptr(yy), x.data_ptr(),
              _ptr(dres), mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
              eps, part.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
              dmean.data_ptr(), dvar.data_ptr(), rows, c,
              _DTYPE_CODE[x.dtype], lanes, int(relu), tx, chunk_rows, chunks)
    bn_grad_stats.launches += 1
    return dres, dweight, dbias, dmean, dvar


def bn_grad_input_reference(dy, y, x, mean, var, weight, eps: float, dmean,
                            dvar, relu: bool = False) -> torch.Tensor:
    """Plain version of kernel D's input gradient: ``dy' * (rsqrt(var + eps)
    * weight)`` (the apply's part; None ``dy`` leaves it out) plus ``(x -
    mean) * (2 * dvar / n) + dmean / n`` (the moments' part, n = N*H*W;
    None ``dmean`` leaves it out), in float32, cast to x's dtype."""
    ft = _float_type(x)
    dx = None
    if dy is not None:
        da = (_relu_grad(dy, y) if relu else dy).to(ft)
        dx = da * _per_channel(torch.rsqrt(var + eps) * weight)
    if dmean is not None:
        n = _rows(x)
        part = ((x.to(ft) - _per_channel(mean)) * _per_channel(2 * dvar / n)
                + _per_channel(dmean / n))
        dx = part if dx is None else dx + part
    return dx.to(x.dtype)


def bn_grad_input(dy, y, x, mean, var, weight, eps: float, dmean, dvar,
                  relu: bool = False) -> torch.Tensor:
    """x's gradient in train-mode BN (see ``bn_grad_input_reference``): both
    parts in one elementwise pass of kernel D on the card, the plain version
    on the CPU."""
    if not _on_card(x):
        return bn_grad_input_reference(dy, y, x, mean, var, weight, eps, dmean,
                                       dvar, relu)
    _check_bn_x(x, dy, y if relu and dy is not None else None)
    if dy is None and dmean is None:
        raise ValueError("bn_grad_input needs dy or dmean")
    params = {}
    if dy is not None:
        params.update(var=var, weight=weight)
    if dmean is not None:
        params.update(mean=mean, dmean=dmean, dvar=dvar)
    _check_bn_params(x, **params)
    dx = torch.empty_like(x)
    yy = y if relu and dy is not None else None
    _launch_d("rdt_bnt_grad_input", x, _ptr(dy), _ptr(yy), x.data_ptr(),
              dx.data_ptr(), _ptr(mean), _ptr(var), _ptr(weight), eps,
              _ptr(dmean), _ptr(dvar), _rows(x), x.shape[1],
              _DTYPE_CODE[x.dtype], _lanes(x, dy, yy, dx), int(relu))
    bn_grad_input.launches += 1
    return dx


bn_stats.launches = 0
bn_apply.launches = 0
bn_grad_stats.launches = 0
bn_grad_input.launches = 0

# the wrappers whose ``.launches`` count a kernel's launches (kernel B's two
# operators count in ``scale_bias_relu``); a graph's replay adds to each what
# its capture counted (``graphs.py``)
LAUNCH_COUNTERS = ("zbuffer_min_depth", "zbuffer_min_depth_sorted",
                   "scale_bias_relu", "bn_stats", "bn_apply", "bn_grad_stats",
                   "bn_grad_input")


class BnTrainLink:
    """Joins one train-mode BN's two autograd nodes. The apply's backward
    leaves its gradient of x here, and the moments' backward, which autograd
    runs after it (the moments feed the apply, directly or through
    ``parallel/mesh.py::global_moments``), writes x's whole gradient, both
    parts, in one pass."""

    __slots__ = ("pending",)

    def __init__(self):
        self.pending = None


class _BnMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plain, link):
        mean, var = (bn_stats_reference if plain else bn_stats)(x)
        ctx.save_for_backward(x, mean)
        ctx.plain, ctx.link = plain, link
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        dy = y = var = weight = None
        eps, relu = 0.0, False
        if ctx.link is not None and ctx.link.pending is not None:
            dy, y, var, weight, eps, relu = ctx.link.pending
            ctx.link.pending = None
        fn = bn_grad_input_reference if ctx.plain else bn_grad_input
        return fn(dy, y, x, mean, var, weight, eps, dmean, dvar, relu), \
            None, None


class _BnApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean, var, weight, bias, residual, eps, relu, running,
                plain, link):
        fn = bn_apply_reference if plain else bn_apply
        y = fn(x, mean, var, weight, bias, eps, residual, relu, running)
        ctx.save_for_backward(x, mean, var, weight, y if relu else None)
        ctx.eps, ctx.relu, ctx.plain, ctx.link = eps, relu, plain, link
        ctx.residual = residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, var, weight, y = ctx.saved_tensors
        if not ctx.plain and dy.is_cuda:  # the kernel's layout
            dy = dy.contiguous(memory_format=torch.channels_last)
        grads = (bn_grad_stats_reference if ctx.plain else bn_grad_stats)(
            dy, y, x, mean, var, weight, ctx.eps, ctx.relu, ctx.residual)
        dres, dweight, dbias, dmean, dvar = grads
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.link is not None and ctx.needs_input_grad[1]:
                ctx.link.pending = (dy, y, var, weight, ctx.eps, ctx.relu)
            else:
                fn = bn_grad_input_reference if ctx.plain else bn_grad_input
                dx = fn(dy, y, x, None, var, weight, ctx.eps, None, None,
                        ctx.relu)
        return (dx, dmean, dvar, dweight, dbias, dres, None, None, None, None,
                None)


def bn_train_moments(x: torch.Tensor, plain: bool = False,
                     link: BnTrainLink | None = None) -> tuple:
    """Differentiable (mean, biased variance) of x over (N, H, W):
    ``bn_stats`` forward, ``bn_grad_input``'s moments part backward
    (``plain=True``: the plain versions on any device). With the ``link``
    of the ``bn_train_apply`` that consumes them, the backward writes x's
    gradient through both nodes in one pass."""
    return _BnMoments.apply(x, plain, link)


def bn_train_apply(x, mean, var, weight, bias, eps: float, residual=None,
                   relu: bool = False, running=None, plain: bool = False,
                   link: BnTrainLink | None = None) -> torch.Tensor:
    """Differentiable ``bn_apply`` (running update included when
    ``running`` is given): ``bn_grad_stats`` backward gives the gradients of
    mean, var, weight, bias and the residual; x's own part is
    ``bn_grad_input``'s, written here without a ``link`` and by the moments'
    backward with one (``plain=True``: the plain versions on any
    device)."""
    return _BnApply.apply(x, mean, var, weight, bias, residual, eps, relu,
                          running, plain, link)
