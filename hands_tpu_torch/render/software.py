"""Host-side software mesh renderer for visualisation (own copy of
``hands_tpu/render/software.py``, numpy only).

A dependency-free z-buffer rasterizer: visualisation runs on the host and is
not on a timed path, so a vectorised numpy fill is enough for the few images
pushed per validation epoch or demo request. Perspective projection with
the patch intrinsics, Lambertian flat shading, an alpha blend onto the
source image, and rotated side views.
"""

from __future__ import annotations

import numpy as np


def rotate_sideview(verts: np.ndarray, deg: float = 90.0) -> np.ndarray:
    """Rotate about the vertical (y) axis around the centroid for the
    side-view render (rend_utils.py:62-78)."""
    c = verts.mean(axis=0, keepdims=True)
    rad = np.deg2rad(deg)
    R = np.asarray(
        [[np.cos(rad), 0, np.sin(rad)], [0, 1, 0], [-np.sin(rad), 0, np.cos(rad)]],
        np.float32,
    )
    return (verts - c) @ R.T + c


def render_mesh(
    verts: np.ndarray,  # (V, 3) camera-space
    faces: np.ndarray,  # (F, 3)
    K: np.ndarray,  # (3, 3)
    img_hw,
    color=(0.65, 0.74, 0.86),
    light_dir=(0.0, 0.0, 1.0),
):
    """Render a mesh -> (H, W, 3) float RGB + (H, W) alpha via z-buffer."""
    H, W = img_hw
    proj = verts @ K.T
    z = np.maximum(proj[:, 2], 1e-6)
    xy = proj[:, :2] / z[:, None]

    # face normals + lambert shading
    tri = verts[faces]  # (F, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n_norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(n_norm, 1e-9)
    shade = np.abs(n @ np.asarray(light_dir, np.float32))
    shade = 0.35 + 0.65 * shade  # ambient + diffuse

    img = np.zeros((H, W, 3), np.float32)
    alpha = np.zeros((H, W), np.float32)
    zbuf = np.full((H, W), np.inf, np.float32)

    p = xy[faces]  # (F, 3, 2)
    zf = z[faces]  # (F, 3)
    # backface/degenerate cull + screen bounds
    lo = np.floor(p.min(axis=1)).astype(int)
    hi = np.ceil(p.max(axis=1)).astype(int)
    valid = (
        (hi[:, 0] >= 0) & (lo[:, 0] < W) & (hi[:, 1] >= 0) & (lo[:, 1] < H)
        & (n_norm[:, 0] > 1e-12)
    )
    order = np.argsort(-zf.mean(axis=1))  # far-to-near painter + zbuffer
    color = np.asarray(color, np.float32)
    for f in order:
        if not valid[f]:
            continue
        x0, y0 = np.maximum(lo[f], 0)
        x1 = min(hi[f][0] + 1, W)
        y1 = min(hi[f][1] + 1, H)
        if x1 <= x0 or y1 <= y0:
            continue
        ys, xs = np.mgrid[y0:y1, x0:x1]
        a, b, c = p[f]
        d = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(d) < 1e-9:
            continue
        w0 = ((b[1] - c[1]) * (xs - c[0]) + (c[0] - b[0]) * (ys - c[1])) / d
        w1 = ((c[1] - a[1]) * (xs - c[0]) + (a[0] - c[0]) * (ys - c[1])) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        zi = w0 * zf[f, 0] + w1 * zf[f, 1] + w2 * zf[f, 2]
        closer = inside & (zi < zbuf[y0:y1, x0:x1])
        zbuf[y0:y1, x0:x1][closer] = zi[closer]
        img[y0:y1, x0:x1][closer] = color * shade[f]
        alpha[y0:y1, x0:x1][closer] = 1.0
    return img, alpha


def overlay_mesh(
    image: np.ndarray,  # (H, W, 3) float [0, 1]
    verts: np.ndarray,
    faces: np.ndarray,
    K: np.ndarray,
    color=(0.65, 0.74, 0.86),
    opacity: float = 0.9,
) -> np.ndarray:
    """Alpha-blend a rendered mesh onto an image (the reference's
    visualize_rends overlay)."""
    H, W = image.shape[:2]
    rend, alpha = render_mesh(verts, faces, K, (H, W), color=color)
    a = (alpha * opacity)[..., None]
    return np.clip(image * (1 - a) + rend * a, 0, 1)
