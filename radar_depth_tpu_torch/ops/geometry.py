"""Batched SE(3) + pinhole camera geometry on tensors, float32 throughout.

Mirrors ``radar_depth_tpu/ops/geometry.py``. Conventions are the same:
quaternions are (w, x, y, z); ``T_a_from_b`` maps points of frame ``b`` into
frame ``a``; camera frame +x right, +y down, +z forward; pixels are (u, v) =
(column, row).

The 3-term products of ``se3_apply`` and ``project_points`` are written as
explicit elementwise chains, not as a matmul, so that every step is rounded
the same way on the CPU and on the card (no BLAS blocking, no TF32). The
chain is the one XLA's CPU dot uses for the JAX reference: a fused
multiply-add per term, ``fma(m2, p2, fma(m1, p1, m0 * p0))``. Each fma is
computed as a float64 product (exact for float32 inputs) plus a float64 add,
rounded once to float32; so the pixel bins and depths of the z-buffer come
out bit-identical to the JAX package's.
"""

from __future__ import annotations

import torch


def _dot(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(m2, p2, fma(m1, p1, m0 * p0))`` over the last axis."""
    m, p = m.double(), p.double()
    acc = (m[..., 0] * p[..., 0]).float()
    for k in range(1, m.shape[-1]):
        acc = (m[..., k] * p[..., k] + acc.double()).float()
    return acc


def _matvec3(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., P, 3) -> (..., P, 3)."""
    M = M[..., None, :, :]
    return torch.stack([_dot(M[..., i, :], p) for i in range(3)], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) (..., 4) in (w, x, y, z) order -> (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def se3_from_rot_trans(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations and (..., 3) translations -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(rot.shape[:-2], trans.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    trans = trans.expand(batch + (3,))
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=rot.dtype, device=rot.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_from_quat_trans(quat: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """SE(3) from nuScenes-style (quaternion wxyz, translation) records."""
    return se3_from_rot_trans(quat_to_rot(quat), trans)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Invert rigid transforms analytically: inv([R|t]) = [R^T | -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t_inv = -_matvec3(Rt, T[..., None, :3, 3])[..., 0, :]
    return se3_from_rot_trans(Rt, t_inv)


def se3_compose(*Ts: torch.Tensor) -> torch.Tensor:
    """se3_compose(A, B, C) = A @ B @ C, in full float32."""
    out = Ts[0]
    for T in Ts[1:]:
        out = _dot(out[..., :, None, :], T.transpose(-1, -2)[..., None, :, :])
    return out


def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., P, 3) points -> (..., P, 3)."""
    return _matvec3(T[..., :3, :3], pts) + T[..., None, :3, 3]


def camera_chain(T_global_from_ego_ref, T_ego_from_cam, T_global_from_ego_sweep,
                 T_ego_from_sensor) -> torch.Tensor:
    """Sensor frame at sweep time -> reference camera frame at sample time:
    inv(T_ego_from_cam) . inv(T_global_from_ego_ref) . T_global_from_ego_sweep
    . T_ego_from_sensor."""
    return se3_compose(se3_inverse(T_ego_from_cam),
                       se3_inverse(T_global_from_ego_ref),
                       T_global_from_ego_sweep, T_ego_from_sensor)


def project_points(pts_cam: torch.Tensor, K: torch.Tensor, eps: float = 1e-6):
    """Pinhole projection of (..., P, 3) camera-frame points with (..., 3, 3)
    intrinsics. Returns uv (..., P, 2) and z (..., P). Points with z <= eps
    give garbage uv; the z-buffer masks on z > min_depth >= 0."""
    z = pts_cam[..., 2]
    proj = _matvec3(K, pts_cam)
    denom = proj[..., 2:3]
    denom = torch.where(denom.abs() < eps, torch.full_like(denom, eps), denom)
    return proj[..., :2] / denom, z
