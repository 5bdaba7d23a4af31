"""Rotation conversions (port of ``hands_tpu/core/rot.py``).

Same conventions as the JAX module: quaternions real-part first, pytorch3d's
four-branch matrix -> quaternion construction, the pytorch3d row-major 6D
layout, SPIN's interleaved column layout and HaMeR's column layout. Shape
polymorphic over leading batch dims; float32 with TF32 off.
"""

from __future__ import annotations

import math

import torch

from hands_tpu_torch.core.precision import f32_matmuls

_EPS = 1e-8


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x <= 0 (the double-where
    keeps gradients of unselected quaternion branches finite)."""
    pos = x > 1e-12
    safe = torch.where(pos, x, torch.ones_like(x))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(x))


def _safe_norm(x: torch.Tensor, dim: int = -1,
               keepdim: bool = True) -> torch.Tensor:
    """L2 norm with finite gradient at 0 (sqrt of clamped square-sum)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=1e-24))


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [w, x, y, z] -> rotation matrix (..., 3, 3)."""
    w, x, y, z = torch.unbind(quat, -1)
    two_s = 2.0 / torch.sum(quat * quat, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (y * y + z * z),
            two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w),
            1 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w),
            two_s * (y * z + x * w),
            1 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return o.reshape(quat.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4): all four
    candidate quaternions, the one with the largest denominator selected."""
    batch = matrix.shape[:-2]
    m = matrix.reshape(batch + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(m, -1)

    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        dim=-2,
    )
    flr = 0.1
    quat_candidates = quat_by_rijk / (
        2.0 * torch.clamp(q_abs[..., None], min=flr))
    # first index of the maximum, as jnp.argmax
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(batch + (1, 4))
    quat = torch.gather(quat_candidates, -2, idx)[..., 0, :]
    return quat / torch.linalg.norm(quat, dim=-1, keepdim=True)


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion (..., 4) [w, x, y, z]."""
    angle = _safe_norm(aa)
    half = angle * 0.5
    small = angle < 1e-6
    sin_half_over_angle = torch.where(
        small, 0.5 - (angle * angle) / 48.0,
        torch.sin(half) / torch.clamp(angle, min=_EPS))
    return torch.cat([torch.cos(half), aa * sin_half_over_angle], dim=-1)


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) [w, x, y, z] -> axis-angle (..., 3)."""
    norms = _safe_norm(quat[..., 1:])
    half_angles = torch.atan2(norms, quat[..., :1])
    angles = 2.0 * half_angles
    small = torch.abs(angles) < 1e-6
    sin_half_over_angle = torch.where(
        small,
        0.5 - (angles * angles) / 48.0,
        torch.sin(half_angles)
        / torch.where(small, torch.ones_like(angles), angles),
    )
    return quat[..., 1:] / sin_half_over_angle


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(aa))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rot6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Continuous 6D (..., 6) -> rotation matrix (..., 3, 3), pytorch3d row
    convention (Gram-Schmidt on the two encoded rows)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(_safe_norm(a1), min=_EPS)
    a2_proj = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2_proj / torch.clamp(_safe_norm(a2_proj), min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rot6d(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> continuous 6D (..., 6): the first two
    rows."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rot6d_to_matrix_hamer(d6: torch.Tensor) -> torch.Tensor:
    """HaMeR's 6D convention: the Gram-Schmidt frame forms the matrix
    *columns* (the transpose of the pytorch3d row decode)."""
    return torch.swapaxes(rot6d_to_matrix(d6), -1, -2)


def rot6d_to_matrix_spin(d6: torch.Tensor) -> torch.Tensor:
    """SPIN/HMR 6D (..., 6) -> rotation matrix: the 6 values are a (3, 2)
    block whose *columns* are the two encoded vectors, and the decoded
    frame forms the matrix *columns*. Identity encodes as
    ``[1, 0, 0, 1, 0, 0]``."""
    block = d6.reshape(d6.shape[:-1] + (3, 2))
    a1, a2 = block[..., 0], block[..., 1]
    b1 = a1 / torch.clamp(_safe_norm(a1), min=_EPS)
    a2_proj = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2_proj / torch.clamp(_safe_norm(a2_proj), min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_rot6d_spin(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> SPIN 6D (..., 6): the first two
    *columns*, flattened row-major."""
    return matrix[..., :, :2].reshape(matrix.shape[:-2] + (6,))


def matrix_to_rot6d_hamer(matrix: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rot6d_to_matrix_hamer`: the first two columns as
    the contiguous halves."""
    return torch.swapaxes(matrix, -1, -2)[..., :2, :].reshape(
        matrix.shape[:-2] + (6,))


def standardize_quaternion(quat: torch.Tensor) -> torch.Tensor:
    """Flip sign so the real part is non-negative."""
    return torch.where(quat[..., :1] < 0, -quat, quat)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two [w, x, y, z] quaternions."""
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, standardised to a non-negative real part."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(quat: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion: its conjugate."""
    sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=quat.dtype,
                        device=quat.device)
    return quat * sign


def quaternion_apply(quat: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate points (..., 3) by unit quaternions (..., 4): q (0, p) q^-1."""
    p_quat = torch.cat([torch.zeros_like(point[..., :1]), point], dim=-1)
    out = quaternion_raw_multiply(
        quaternion_raw_multiply(quat, p_quat), quaternion_invert(quat))
    return out[..., 1:]


@f32_matmuls
def euler_angles_to_matrix(euler: torch.Tensor,
                           convention: str = "XYZ") -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrix, ``R = Rx @ Ry @ Rz`` for
    convention 'XYZ' (pytorch3d ``euler_angles_to_matrix``)."""

    def axis_rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
        c, s = torch.cos(angle), torch.sin(angle)
        one, zero = torch.ones_like(angle), torch.zeros_like(angle)
        if axis == "X":
            flat = [one, zero, zero, zero, c, -s, zero, s, c]
        elif axis == "Y":
            flat = [c, zero, s, zero, one, zero, -s, zero, c]
        elif axis == "Z":
            flat = [c, -s, zero, s, c, zero, zero, zero, one]
        else:
            raise ValueError(axis)
        return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))

    mats = [axis_rot(ax, euler[..., i])
            for i, ax in enumerate(convention.upper())]
    return mats[0] @ mats[1] @ mats[2]


@f32_matmuls
def rot_aa(aa: torch.Tensor, rot_deg: torch.Tensor) -> torch.Tensor:
    """Rotate an axis-angle global orientation by ``rot_deg`` degrees about
    the camera z-axis (augmentation semantics)."""
    rad = -rot_deg * math.pi / 180.0
    c, s = torch.cos(rad), torch.sin(rad)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([c, -s, zero, s, c, zero, zero, zero, one],
                    dim=-1).reshape(rot_deg.shape + (3, 3))
    per_sample = axis_angle_to_matrix(aa)
    quat = standardize_quaternion(matrix_to_quaternion(R @ per_sample))
    return quaternion_to_axis_angle(quat)


def flip_axis_angle(aa_flat: torch.Tensor) -> torch.Tensor:
    """Mirror a flattened axis-angle pose (..., 3J): negate the y and z
    components (the left/right flip-swap of the model)."""
    shape = aa_flat.shape
    aa = aa_flat.reshape(shape[:-1] + (-1, 3))
    sign = torch.tensor([1.0, -1.0, -1.0], dtype=aa.dtype, device=aa.device)
    return (aa * sign).reshape(shape)
