"""Device ops of the port: geometry, rasterization, preprocessing and the
hand-written CUDA kernels (``kernels``).

The package exports the names that the JAX package's ``ops`` package
exports (``__all__``). They are loaded at first access, so that importing
the package alone loads neither ``raster`` nor the kernels' module; no
kernel is built before a CUDA tensor reaches it.
"""

import importlib

_HOME = {
    "quat_to_rot": "geometry",
    "se3_from_rot_trans": "geometry",
    "se3_from_quat_trans": "geometry",
    "se3_inverse": "geometry",
    "se3_compose": "geometry",
    "se3_apply": "geometry",
    "project_points": "geometry",
    "camera_chain": "geometry",
    "rasterize_min_depth": "raster",
    "accumulate_sweeps": "raster",
    "radar_to_depth_map": "raster",
    "extend_height": "raster",
}

__all__ = list(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
