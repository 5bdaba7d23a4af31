"""Minimal coloured-mesh container (own copy of ``hands_tpu/core/mesh.py``,
numpy only): vertices, faces and per-vertex colours, with concatenation and
OBJ export for offline inspection."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Mesh:
    v: np.ndarray  # (V, 3)
    f: np.ndarray  # (F, 3) int
    vc: Optional[np.ndarray] = None  # (V, 3) float [0, 1]

    def __post_init__(self):
        self.v = np.asarray(self.v, np.float32)
        self.f = np.asarray(self.f, np.int64)
        if self.vc is None:
            self.vc = np.ones_like(self.v) * 0.7

    def set_vc(self, color) -> "Mesh":
        color = np.asarray(color, np.float32).reshape(1, 3)
        self.vc = np.tile(color, (len(self.v), 1))
        return self

    @staticmethod
    def cat(meshes: List["Mesh"]) -> "Mesh":
        vs, fs, vcs = [], [], []
        offset = 0
        for m in meshes:
            vs.append(m.v)
            fs.append(m.f + offset)
            vcs.append(m.vc)
            offset += len(m.v)
        return Mesh(np.concatenate(vs), np.concatenate(fs),
                    np.concatenate(vcs))

    def export_obj(self, path: str) -> str:
        with open(path, "w") as fp:
            for p, c in zip(self.v, self.vc):
                fp.write(f"v {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
            for tri in self.f:
                fp.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")
        return path
