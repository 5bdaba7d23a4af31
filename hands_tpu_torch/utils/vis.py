"""Validation-epoch and demo visualisation (port of
``hands_tpu/utils/vis.py``).

The figure set of the JAX module: per example a keypoint grid for the
ground truth and one for the prediction (2 x 2 panels: annotated 2D
keypoints, the 2D box panel, the 3D joints reprojected through K, the 3D box
panel), and a titled strip [input | GT render | pred render] in which each
render panel is the in-image overlay stacked over three rotated side views.
The renders are the software renderer's (``render/software.py``), numpy as
in the JAX package. The figures are drawn with PIL, not matplotlib (the
card's machine has no matplotlib): the panels that carry data (the renders,
the overlays, the side views, the projected keypoints) are the JAX
module's, the framing, fonts and markers are PIL's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from hands_tpu_torch.render.software import overlay_mesh, rotate_sideview

# marker colours: right hand red, left hand blue, as the JAX grids
RIGHT_RGB, LEFT_RGB = (255, 0, 0), (0, 0, 255)
BOX_RGB = (255, 255, 0)
TITLE_H = 18  # pixels of the title band above a panel
PAD = 4  # pixels between panels


def _font():
    return ImageFont.load_default()


def to_uint8(image: np.ndarray) -> np.ndarray:
    """A float [0, 1] or uint8 HWC image -> uint8 HWC."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return (np.clip(image, 0, 1) * 255).round().astype(np.uint8)


def fig2img(fig: Image.Image) -> np.ndarray:
    """A drawn figure (a PIL image) -> (H, W, 3) uint8."""
    return np.asarray(fig.convert("RGB"), dtype=np.uint8).copy()


def plot_2d_bbox(draw: ImageDraw.ImageDraw, bbox_xyxy, color=BOX_RGB):
    """Outline a box [x0, y0, x1, y1] in pixels."""
    x0, y0, x1, y1 = (float(v) for v in bbox_xyxy)
    draw.rectangle([x0, y0, x1, y1], outline=color, width=1)


def denormalize_image(img_chw_or_hwc: np.ndarray, mean, std) -> np.ndarray:
    img = np.asarray(img_chw_or_hwc)
    if img.shape[0] == 3 and img.ndim == 3:
        img = img.transpose(1, 2, 0)
    return np.clip(img * np.asarray(std) + np.asarray(mean), 0, 1)


def draw_crosses(draw, kp: np.ndarray, color, r: int = 3) -> None:
    """An 'x' marker at each (x, y) of kp (J, 2)."""
    for x, y in np.asarray(kp, np.float64):
        if np.isfinite(x) and np.isfinite(y):
            draw.line([x - r, y - r, x + r, y + r], fill=color, width=1)
            draw.line([x - r, y + r, x + r, y - r], fill=color, width=1)


def draw_dots(draw, kp: np.ndarray, color, r: int = 2) -> None:
    for x, y in np.asarray(kp, np.float64):
        if np.isfinite(x) and np.isfinite(y):
            draw.ellipse([x - r, y - r, x + r, y + r], fill=color)


def titled(panel: Image.Image, title: str) -> Image.Image:
    """The panel under a white title band."""
    out = Image.new("RGB", (panel.width, panel.height + TITLE_H), "white")
    out.paste(panel, (0, TITLE_H))
    ImageDraw.Draw(out).text((2, 3), title, fill=(0, 0, 0), font=_font())
    return out


def _grid(panels: Sequence[Image.Image], cols: int) -> Image.Image:
    """Panels of one size in rows of ``cols``, PAD pixels apart."""
    w, h = panels[0].size
    rows = -(-len(panels) // cols)
    out = Image.new("RGB", (cols * w + (cols - 1) * PAD,
                            rows * h + (rows - 1) * PAD), "white")
    for i, p in enumerate(panels):
        out.paste(p, ((i % cols) * (w + PAD), (i // cols) * (h + PAD)))
    return out


def visualize_kps(image: np.ndarray,
                  kp_sets: List[Tuple[str, np.ndarray]],
                  title: str = "") -> np.ndarray:
    """The image with each labelled (J, 2) pixel keypoint set, a legend
    line per set, under a title."""
    colors = [RIGHT_RGB, LEFT_RGB, (0, 160, 0), (255, 128, 0)]
    panel = Image.fromarray(to_uint8(image))
    draw = ImageDraw.Draw(panel)
    for i, (label, kp) in enumerate(kp_sets):
        color = colors[i % len(colors)]
        draw_dots(draw, kp, color)
        draw.text((2, 2 + 11 * i), label, fill=color, font=_font())
    return fig2img(titled(panel, title))


def im_list_to_plt(image_list, title_list=None) -> np.ndarray:
    """A one-row strip of titled panels."""
    panels = [Image.fromarray(to_uint8(im)) for im in image_list]
    titles = title_list or [""] * len(panels)
    h = max(p.height for p in panels)
    padded = []
    for p, t in zip(panels, titles):
        canvas = Image.new("RGB", (p.width, h), "white")
        canvas.paste(p, (0, 0))
        padded.append(titled(canvas, t))
    out = Image.new("RGB", (sum(p.width for p in padded)
                            + PAD * (len(padded) - 1), h + TITLE_H), "white")
    x = 0
    for p in padded:
        out.paste(p, (x, 0))
        x += p.width + PAD
    return fig2img(out)


def visualize_one_example_kps(
    image: np.ndarray,  # (H, W, 3) [0, 1]
    j2d_r: np.ndarray, j2d_l: np.ndarray,  # (21, 2) pixel coords
    j2d_proj_r: np.ndarray, j2d_proj_l: np.ndarray,  # K-reprojected 3D
    joints_valid_r: np.ndarray, joints_valid_l: np.ndarray,  # (21,)
    flag: str,
) -> np.ndarray:
    """The 2 x 2 keypoint grid: [0] annotated 2D keypoints, [1] the 2D box
    panel, [2] the 3D joints reprojected through K, [3] the 3D box panel;
    valid joints only, right red, left blue, 'x' markers."""
    vr = np.where(np.asarray(joints_valid_r) == 1)[0]
    vl = np.where(np.asarray(joints_valid_l) == 1)[0]
    base = Image.fromarray(to_uint8(image))
    panels = []
    for title, pts in ((f"{flag} 2D keypoints", (j2d_r, j2d_l)),
                       (f"{flag} 2D bbox", None),
                       (f"{flag} 3D keypoints reprojection from cam",
                        (j2d_proj_r, j2d_proj_l)),
                       (f"{flag} 3D keypoints reprojection from cam", None)):
        panel = base.copy()
        if pts is not None:
            draw = ImageDraw.Draw(panel)
            draw_crosses(draw, np.asarray(pts[0])[vr], RIGHT_RGB)
            draw_crosses(draw, np.asarray(pts[1])[vl], LEFT_RGB)
        panels.append(titled(panel, title))
    return fig2img(_grid(panels, 2))


def visualize_rend_stack(
    image: np.ndarray,
    verts_list: List[np.ndarray],
    faces_list: List[np.ndarray],
    K: np.ndarray,
) -> np.ndarray:
    """The in-image render and 3 side views rotated by linspace(45, 300, 3)
    degrees, stacked vertically."""
    over = image.copy()
    colors = [(100 / 255, 100 / 255, 254 / 255),
              (183 / 255, 100 / 255, 254 / 255)]  # right, left
    for i, (v, f) in enumerate(zip(verts_list, faces_list)):
        over = overlay_mesh(over, v, f, K, color=colors[i % 2])
    panels = [over]
    if verts_list:
        for angle in np.linspace(45, 300, 3):
            side = np.ones_like(image)
            for i, (v, f) in enumerate(zip(verts_list, faces_list)):
                side = overlay_mesh(side, rotate_sideview(v, angle), f, K,
                                    color=colors[i % 2])
            panels.append(side)
    else:
        panels = [image] * 4  # the reference's stand-in without meshes
    return np.concatenate(panels, axis=0)


def visualize_mesh_overlay(
    image: np.ndarray,  # (H, W, 3) [0, 1]
    verts_list: List[np.ndarray],  # camera-space (V, 3) meshes
    faces_list: List[np.ndarray],
    K: np.ndarray,
    sideview: bool = True,
) -> np.ndarray:
    """GT / pred overlay and an optional side view, side by side."""
    colors = [(0.65, 0.74, 0.86), (0.86, 0.65, 0.65)]
    over = image.copy()
    for i, (v, f) in enumerate(zip(verts_list, faces_list)):
        over = overlay_mesh(over, v, f, K, color=colors[i % 2])
    panels = [over]
    if sideview:
        side = np.ones_like(image)
        for i, (v, f) in enumerate(zip(verts_list, faces_list)):
            side = overlay_mesh(side, rotate_sideview(v), f, K,
                                color=colors[i % 2])
        panels.append(side)
    return np.concatenate(panels, axis=1)


def _project2d(j3d: np.ndarray, K: np.ndarray) -> np.ndarray:
    p = j3d @ K.T
    return p[:, :2] / np.maximum(p[:, 2:], 1e-9)


def _host_dict(vis_dict) -> dict:
    """Every tensor of the dict as a host numpy array (bf16 widened)."""
    import torch

    out = {}
    for k, v in vis_dict.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        out[k] = v
    return out


def example_panels(vis_dict, cfg, i: int, faces) -> dict:
    """The data of example i's figures: the image, joint validity, the
    keypoint sets of each grid ``kps[flag] = (j2d_r, j2d_l, proj_r,
    proj_l)`` and the render stacks ``rends = [(title, stack)]``.
    ``vis_dict`` holds host arrays; ``faces`` maps "r"/"l" to MANO faces."""
    def get(key, default=None):
        return np.asarray(vis_dict[key][i]) if key in vis_dict else default

    img = denormalize_image(np.asarray(vis_dict["inputs.img"][i]),
                            cfg.img_norm_mean, cfg.img_norm_std)
    K = np.asarray(vis_dict["meta_info.intrinsics"][i])
    ones21 = np.ones(21)
    out = {"img": img, "jv_r": get("targets.joints_valid_r", ones21),
           "jv_l": get("targets.joints_valid_l", ones21), "kps": {},
           "rends": [],
           "rvalid": float(np.asarray(get("targets.right_valid", 1.0))),
           "lvalid": float(np.asarray(get("targets.left_valid", 1.0)))}
    for flag in ("targets", "pred"):
        j2d, proj = {}, {}
        for s in ("r", "l"):
            kp = get(f"{flag}.mano.j2d.norm.{s}")
            if kp is None:
                break
            j2d[s] = (kp[:, :2] + 1) * 0.5 * cfg.img_res
            j3d = get(f"{flag}.mano.j3d.cam.{s}")
            if j3d is None:
                j3d = get(f"{flag}.mano.j3d.full.{s}")
            proj[s] = _project2d(j3d, K) if j3d is not None else j2d[s]
        else:
            out["kps"][flag] = (j2d["r"], j2d["l"], proj["r"], proj["l"])
    for flag, title in (("targets", "GT"), ("pred", "pred w/ pred_cam_t")):
        verts, fcs = [], []
        for s in ("r", "l"):
            v = get(f"{flag}.mano.v3d.cam.{s}")
            if v is not None:
                verts.append(v)
                fcs.append(faces[s])
        if verts:
            out["rends"].append((title, visualize_rend_stack(img, verts, fcs,
                                                             K)))
    return out


def visualize_all(vis_dict, cfg, max_examples: int = 1,
                  prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    """The per-epoch image set: for each example a GT and a pred 2 x 2
    keypoint grid and the titled [input | GT render | pred render] strip.
    ``vis_dict`` holds ``inputs.*``, ``pred.*``, ``targets.*`` and
    ``meta_info.*`` tensors or arrays. Returns [(figure name, HWC uint8)]."""
    from hands_tpu_torch.ops import mano as manolib

    vis_dict = _host_dict(vis_dict)
    faces = {"r": manolib.load_mano(True).faces.numpy(),
             "l": manolib.load_mano(False).faces.numpy()}
    images = []
    n = min(max_examples, np.asarray(vis_dict["inputs.img"]).shape[0])
    for i in range(n):
        ex = example_panels(vis_dict, cfg, i, faces)
        for flag, (j2d_r, j2d_l, proj_r, proj_l) in ex["kps"].items():
            images.append((f"{prefix}{i}__{flag}_kps",
                           visualize_one_example_kps(
                               ex["img"], j2d_r, j2d_l, proj_r, proj_l,
                               ex["jv_r"], ex["jv_l"], flag)))
        if ex["rends"]:
            titles = ["input image"] + [t for t, _ in ex["rends"]]
            strip = im_list_to_plt([ex["img"]] + [r for _, r in ex["rends"]],
                                   title_list=titles)
            images.append((f"{prefix}{i}__rend_rvalid={ex['rvalid']:g}, "
                           f"lvalid={ex['lvalid']:g}", strip))
    return images
