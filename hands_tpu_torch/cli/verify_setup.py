"""First-contact verification against the real licensed assets (port of
``hands_tpu/cli/verify_setup.py``): the same checks, verdicts and exit code.

    MANO_DIR=.../mano_v1_2/models SMPLX_DIR=.../smplx/models \\
    DATA_DIR=.../data python -m hands_tpu_torch.cli.verify_setup \\
        [--datasets arctic epic ...] [--device cpu]

Checks (each runs if its packages and assets are present, else SKIP):
  mano_fk        the port's MANO FK (K1 on the card) against the smplx
                 package on the real pkls: vertices and joints < 1e-5 m,
                 both hands
  smplx_body_fk  ops/smplx_body against smplx.SMPLX on the real npz
  rasterizer     ops/rasterizer's silhouette (K2 on the card) against
                 pytorch3d's SoftSilhouetteShader
  dataset:<name> the real download under $DATA_DIR through the port's
                 loader, one batch end to end

Exit code 0 if nothing FAILED (SKIPs are fine), 1 otherwise.
"""

from __future__ import annotations

import argparse
import os
import traceback

import numpy as np
import torch

PASS, SKIP, FAIL = "PASS", "SKIP", "FAIL"


def _have_smplx():
    try:
        import smplx  # noqa: F401

        return True
    except ImportError:
        return False


def _have_pytorch3d():
    try:
        from pytorch3d import renderer  # noqa: F401

        return True
    except ImportError:
        return False


def mano_assets_present():
    d = os.environ.get("MANO_DIR", "")
    return bool(d) and all(
        os.path.exists(os.path.join(d, f"MANO_{s}.pkl"))
        for s in ("RIGHT", "LEFT"))


def smplx_assets_present():
    d = os.environ.get("SMPLX_DIR", "")
    return bool(d) and os.path.exists(os.path.join(d, "SMPLX_NEUTRAL.npz"))


def _max_diff(ours, ref_out):
    """(vertex, joint, joint count) max distances of (vertices, joints)
    against an smplx output."""
    rv, rj = ref_out.vertices.numpy(), ref_out.joints.numpy()
    ov, oj = ours.vertices.cpu().numpy(), ours.joints.cpu().numpy()
    nj = min(oj.shape[1], rj.shape[1])
    return (float(np.abs(ov - rv).max()),
            float(np.abs(oj[:, :nj] - rj[:, :nj]).max()), nj)


@torch.no_grad()
def check_mano_fk(tol: float = 1e-5, batch: int = 8, device="cuda"):
    """The port's FK against smplx on the licensed pkls (MANO(dir, is_rhand,
    use_pca=False, flat_hand_mean=False))."""
    if not mano_assets_present():
        return SKIP, "MANO_DIR not set / pkls absent"
    if not _have_smplx():
        return SKIP, "smplx package not installed"
    import smplx

    from hands_tpu_torch.ops import mano as manolib

    rng = np.random.RandomState(0)
    betas = rng.randn(batch, 10).astype(np.float32) * 0.5
    pose = rng.randn(batch, 45).astype(np.float32) * 0.4
    orient = rng.randn(batch, 3).astype(np.float32) * 0.5

    worst = 0.0
    for is_rhand in (True, False):
        t = [torch.from_numpy(a).to(device) for a in (betas, pose, orient)]
        ours = manolib.mano_forward(
            manolib.load_mano(is_rhand, flat_hand_mean=False, device=device),
            *t)
        ref = smplx.MANO(
            os.environ["MANO_DIR"], is_rhand=is_rhand, use_pca=False,
            flat_hand_mean=False, batch_size=batch)
        out = ref(betas=torch.from_numpy(betas),
                  hand_pose=torch.from_numpy(pose),
                  global_orient=torch.from_numpy(orient))
        dv, dj, nj = _max_diff(ours, out)
        worst = max(worst, dv, dj)
        side = "right" if is_rhand else "left"
        if max(dv, dj) > tol:
            return FAIL, (f"{side}: verts {dv:.2e} joints({nj}) {dj:.2e} "
                          f"> {tol:.0e}")
    return PASS, f"both hands verts+joints < {worst:.2e} (tol {tol:.0e})"


@torch.no_grad()
def check_smplx_body_fk(tol: float = 1e-5, batch: int = 4, device="cuda"):
    """ops/smplx_body (the ARCTIC GT build's FK) against smplx.SMPLX on the
    real npz."""
    if not smplx_assets_present():
        return SKIP, "SMPLX_DIR not set / npz absent"
    if not _have_smplx():
        return SKIP, "smplx package not installed"
    import smplx

    from hands_tpu_torch.ops import smplx_body

    rng = np.random.RandomState(0)
    kw = {
        "global_orient": rng.randn(batch, 3).astype(np.float32) * 0.3,
        "body_pose": rng.randn(batch, 63).astype(np.float32) * 0.2,
        "jaw_pose": rng.randn(batch, 3).astype(np.float32) * 0.1,
        "leye_pose": rng.randn(batch, 3).astype(np.float32) * 0.1,
        "reye_pose": rng.randn(batch, 3).astype(np.float32) * 0.1,
        "left_hand_pose": rng.randn(batch, 45).astype(np.float32) * 0.3,
        "right_hand_pose": rng.randn(batch, 45).astype(np.float32) * 0.3,
        "transl": rng.randn(batch, 3).astype(np.float32) * 0.5,
        "betas": rng.randn(batch, 10).astype(np.float32) * 0.5,
    }
    model = smplx_body.load_body_model("neutral", use_pca=False,
                                       flat_hand_mean=True, device=device)
    ours = smplx_body.body_forward(
        model, **{k: torch.from_numpy(v).to(device) for k, v in kw.items()})
    ref = smplx.SMPLX(
        os.environ["SMPLX_DIR"], gender="neutral", use_pca=False,
        flat_hand_mean=True, batch_size=batch)
    dv, dj, nj = _max_diff(
        ours, ref(**{k: torch.from_numpy(v) for k, v in kw.items()}))
    if max(dv, dj) > tol:
        return FAIL, f"verts {dv:.2e} joints({nj}) {dj:.2e} > {tol:.0e}"
    return PASS, f"verts {dv:.2e} joints({nj}) {dj:.2e} (tol {tol:.0e})"


@torch.no_grad()
def check_rasterizer(batch: int = 2, res: int = 64, device="cuda"):
    """ops/rasterizer's soft silhouette against pytorch3d's
    SoftSilhouetteShader (the reference renderer's blur radius and sigma)."""
    if not _have_pytorch3d():
        return SKIP, "pytorch3d not installed"
    from pytorch3d.renderer import (BlendParams, MeshRasterizer,
                                    MeshRenderer, PerspectiveCameras,
                                    RasterizationSettings,
                                    SoftSilhouetteShader)
    from pytorch3d.structures import Meshes

    from hands_tpu_torch.ops import mano as manolib
    from hands_tpu_torch.ops.rasterizer import render_silhouette

    model = manolib.load_mano(True, device=device)
    rng = np.random.RandomState(0)
    betas = torch.from_numpy((rng.randn(batch, 10) * 0.3).astype(np.float32))
    pose = torch.from_numpy((rng.randn(batch, 45) * 0.2).astype(np.float32))
    out = manolib.mano_forward(model, betas.to(device), pose.to(device),
                               torch.zeros((batch, 3), device=device))
    verts = out.vertices.cpu().numpy() + np.array([0, 0, 0.5], np.float32)
    faces = model.faces.cpu().numpy()

    K = np.tile(np.asarray(
        [[5000.0 * res / 224, 0, res / 2],
         [0, 5000.0 * res / 224, res / 2], [0, 0, 1]], np.float32),
        (batch, 1, 1))
    ours = render_silhouette(
        torch.from_numpy(verts).to(device), model.faces,
        torch.from_numpy(K).to(device), res).cpu().numpy()

    sigma = 1e-4
    cameras = PerspectiveCameras(
        focal_length=torch.tensor([[K[0, 0, 0], K[0, 1, 1]]]).repeat(
            batch, 1),
        principal_point=torch.tensor([[K[0, 0, 2], K[0, 1, 2]]]).repeat(
            batch, 1),
        in_ndc=False, image_size=torch.tensor([[res, res]]).repeat(batch, 1))
    raster_settings = RasterizationSettings(
        image_size=res, blur_radius=np.log(1.0 / 1e-4 - 1.0) * sigma,
        faces_per_pixel=50)
    renderer = MeshRenderer(
        rasterizer=MeshRasterizer(cameras=cameras,
                                  raster_settings=raster_settings),
        shader=SoftSilhouetteShader(blend_params=BlendParams(sigma=sigma)))
    # pytorch3d's cameras look down +z with x left and y up: flip x, y
    vt = torch.from_numpy(verts * np.array([-1, -1, 1], np.float32))
    meshes = Meshes(verts=[v for v in vt],
                    faces=[torch.from_numpy(faces.astype(np.int64))] * batch)
    ref = renderer(meshes)[..., 3].numpy()
    iou = float(np.minimum(ours, ref).sum()
                / (np.maximum(ours, ref).sum() + 1e-9))
    if iou < 0.9:
        return FAIL, f"soft-silhouette IoU {iou:.3f} < 0.9"
    return PASS, f"soft-silhouette IoU {iou:.3f}"


def check_dataset(name: str, setup: str = "p2a", device="cuda"):
    """The real dataset from $DATA_DIR, one batch through the port's
    loader and on-device preprocessing."""
    if not os.environ.get("DATA_DIR"):
        return SKIP, "DATA_DIR not set"
    try:
        from hands_tpu_torch.config import default_config
        from hands_tpu_torch.data.datasets import fetch_dataset
        from hands_tpu_torch.data.device_pipeline import DeviceDataLoader

        cfg = default_config("hands_light", setup=setup,
                             use_render_seg_loss=False, num_workers=0)
        ds = fetch_dataset(cfg, name, "minival")
        n = len(ds)
        if n == 0:
            return FAIL, "dataset is empty"
        loader = DeviceDataLoader(ds, cfg, min(4, n), is_train=False,
                                  seed=0, device=device)
        inputs, _, _ = next(iter(loader))
        img = inputs["img"] if "img" in inputs else next(iter(inputs.values()))
        if not bool(torch.isfinite(img.float()).all()):
            return FAIL, "non-finite batch values"
        return PASS, f"{n} samples, one batch through the device pipeline"
    except FileNotFoundError as e:
        return SKIP, f"download absent: {e}"
    except Exception as e:  # noqa: BLE001 - report, don't end the sweep
        return FAIL, f"{type(e).__name__}: {e}"


DATASET_FAMILIES = ("arctic", "assembly", "epic", "h2o", "egoexo",
                    "epic_grasp", "ego_grasp", "epic_seg", "ego_seg",
                    "epic_depth")


def run_all(datasets=DATASET_FAMILIES, verbose: bool = True, device="cuda"):
    """{check name: (verdict, detail)} of every check, printed as it runs."""
    checks = [("mano_fk", lambda: check_mano_fk(device=device)),
              ("smplx_body_fk", lambda: check_smplx_body_fk(device=device)),
              ("rasterizer", lambda: check_rasterizer(device=device))]
    checks += [(f"dataset:{d}", lambda d=d: check_dataset(d, device=device))
               for d in datasets]
    results = {}
    for name, fn in checks:
        try:
            status, detail = fn()
        except Exception as e:  # noqa: BLE001 - a failed check is a verdict
            status, detail = FAIL, f"{type(e).__name__}: {e}"
            if verbose:
                traceback.print_exc()
        results[name] = (status, detail)
        if verbose:
            print(f"[{status}] {name:20s} {detail}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datasets", nargs="*", default=list(DATASET_FAMILIES))
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    results = run_all(args.datasets, device=args.device)
    n_fail = sum(1 for s, _ in results.values() if s == FAIL)
    n_pass = sum(1 for s, _ in results.values() if s == PASS)
    print(f"{n_pass} passed, {n_fail} failed, "
          f"{len(results) - n_pass - n_fail} skipped")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
