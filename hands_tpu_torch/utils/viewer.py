"""Headless sequence viewer (port of ``hands_tpu/utils/viewer.py``): the
predicted hand meshes of a sequence rendered over its frames with the
software renderer, written as an animated GIF or a frame strip (PIL)."""

from __future__ import annotations

import os
from typing import List

import numpy as np
from PIL import Image

from hands_tpu_torch.render.software import overlay_mesh, rotate_sideview


def render_sequence(
    images: np.ndarray,  # (T, H, W, 3) float [0, 1]
    verts_seq: List[np.ndarray],  # over hands: (T, V, 3) camera space
    faces_list: List[np.ndarray],
    K: np.ndarray,  # (3, 3) or (T, 3, 3)
    sideview: bool = False,
) -> np.ndarray:
    """-> (T, H, W * (1 + sideview), 3) rendered frames."""
    colors = [(0.65, 0.74, 0.86), (0.86, 0.65, 0.65)]
    frames = []
    for t in range(images.shape[0]):
        Kt = K if K.ndim == 2 else K[t]
        frame = images[t].copy()
        for i, (vs, f) in enumerate(zip(verts_seq, faces_list)):
            frame = overlay_mesh(frame, vs[t], f, Kt, color=colors[i % 2])
        if sideview:
            side = np.ones_like(images[t])
            for i, (vs, f) in enumerate(zip(verts_seq, faces_list)):
                side = overlay_mesh(side, rotate_sideview(vs[t]), f, Kt,
                                    color=colors[i % 2])
            frame = np.concatenate([frame, side], axis=1)
        frames.append(frame)
    return np.stack(frames)


def _uint8(frame: np.ndarray) -> np.ndarray:
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


def save_gif(frames: np.ndarray, path: str, fps: int = 10) -> str:
    """(T, H, W, 3) float [0, 1] -> an animated GIF."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = [Image.fromarray(_uint8(f)) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return path


def save_strip(frames: np.ndarray, path: str, max_frames: int = 8) -> str:
    """A horizontal contact sheet of up to ``max_frames`` evenly spaced
    frames."""
    idx = np.linspace(0, len(frames) - 1, min(max_frames, len(frames)))
    strip = np.concatenate([frames[int(i)] for i in idx], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(_uint8(strip)).save(path)
    return path
