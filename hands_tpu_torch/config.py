"""Typed configuration system (the port's own copy of
``hands_tpu/config.py``: same fields, defaults and flag names, so that a
``Config`` means the same in both packages).

Replaces the reference's argparse -> EasyDict mutable global singleton
(``src/parsers/parser.py:9``, ``src/utils/const.py:5`` there) with a
frozen dataclass tree + a method registry. CLI flag names and per-method
defaults mirror ``src/parsers/configs/*.py`` so reference run commands
translate 1:1; hardcoded globals (focal_length=1000, rot/noise/scale factors,
seed, grad clip) follow ``parser.py:39-58``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # --- method / model
    method: str = "hands_light"
    backbone: str = "resnet50"
    pos_enc: Optional[str] = "center+corner_latent"
    n_freq_pos_enc: int = 4
    separate_hands: bool = False
    tf_decoder: bool = False
    no_crops: bool = False
    use_glb_feat: bool = True
    use_glb_feat_w_grasp: bool = False
    use_grasp_loss: bool = True
    use_render_seg_loss: bool = True
    use_depth_loss: bool = False
    regress_center_corner: bool = False
    no_intrx: bool = False

    # --- image/camera
    img_res: int = 224
    img_res_ds: int = 224
    focal_length: float = 1000.0
    use_gt_k: bool = False
    # GT-joint-derived hand boxes (reference configs/*_light.py all pin
    # use_gt_bbox=True — detected boxes only on the EPIC test path)
    use_gt_bbox: bool = True
    bbox_scale: float = 1.5
    ego_image_scale: float = 0.3

    # --- augmentation (reference parser.py:39-58)
    rot_factor: float = 30.0
    noise_factor: float = 0.4
    scale_factor: float = 0.25
    flip_prob: float = 0.0
    img_norm_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    img_norm_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    # --- data
    dataset: str = "hands+assembly+epic_grasp+epic_seg"
    # GT VISOR masks instead of predicted ones for the seg datasets
    # (reference epic_seg_dataset.py:44-48, args.get('use_gt_hand_mask'))
    use_gt_hand_mask: bool = False
    val_dataset: str = "epic"
    setup: str = "p2a"  # reference generic.py:33 default (ARCTIC ego split)
    trainsplit: str = "train"
    valsplit: str = "minival"
    window_size: int = 11
    num_workers: int = 16
    speedup: bool = True

    # --- optimisation
    lr: float = 1e-5
    lr_dec_epoch: Tuple[int, ...] = ()
    lr_dec_factor: float = 10.0
    lr_decay: float = 0.1
    num_epoch: int = 100
    batch_size: int = 64
    test_batch_size: int = 128
    acc_grad: int = 1
    grad_clip: float = 150.0
    seed: int = 1

    # --- runtime
    eval_every_epoch: int = 5
    log_every: int = 50
    # mid-epoch 'last' checkpointing for preemption tolerance (0 = only at
    # epoch end, like the reference)
    save_every_steps: int = 0
    num_exp: int = 1
    exp_key: str = ""
    extraction_mode: str = ""
    # extraction/eval companions (reference generic.py): dataset override
    # for evaluation, feature-split consumption knobs
    eval_on: str = ""
    run_on: str = ""
    temp_loader: bool = False
    img_feat_version: str = ""
    mute: bool = False
    no_vis: bool = False
    cluster: bool = False
    fast_dev_run: bool = False
    debug: bool = False
    logger: str = "tensorboard"

    # --- checkpoints
    load_ckpt: str = ""
    # orbax dir from cli/convert_ckpt: pretrained backbone warm start
    load_backbone: str = ""
    resume_ckpt: str = ""
    infer_ckpt: str = ""
    load_from: str = ""

    # --- serving and runtime knobs (no reference equivalent)
    # JPEG decode-at-scale for the in-the-wild frame datasets (epic/grasp):
    # libjpeg scale_denom in {1, 2, 4, 8}; the decoded frame only feeds a
    # 224px on-device patch
    decode_downscale: int = 1
    # tanh-approximate GELU in the ViT backbone (lossy against the
    # reference's exact erf GELU)
    fast_gelu: bool = False
    # W8A8 dynamic-int8 ViT block matmuls at inference: per-token
    # activation scales, per-output-channel weight scales (lossy)
    quant_int8: bool = False
    # static-calibrated per-channel int8 activation scales inside the
    # fused block (implies quant_int8). Requires a calibration pass
    # (ops/calibration.py / cli/calibrate.py) to fill the act_scale_*
    # params before serving
    quant_int8_static: bool = False
    # internal: calibration forward pass, the plain bf16 path recording
    # per-channel activation maxima
    quant_calibrate: bool = False
    # fused ViT transformer-block kernels at inference (bf16 only): same
    # math and rounding points as the plain block
    fused_block: bool = False
    compute_dtype: str = "bfloat16"  # backbone matmul dtype
    mesh_shape: Tuple[int, ...] = (-1,)  # data-parallel axis; -1 = all devices
    mesh_axis_names: Tuple[str, ...] = ("data",)
    # fully-sharded data parallelism over the data axis; no-op on one device
    fsdp: bool = False
    # multi-host: one process per host; set all three explicitly
    num_processes: int = 1
    process_id: int = 0
    coordinator_address: str = ""
    # capture a profiler trace of N training steps (after 2 warmup steps)
    # into logs/<key>/trace
    profile_steps: int = 0

    def get(self, key, default=None):
        """EasyDict-compatible accessor used by code ported from args.get()."""
        return getattr(self, key, default)

    def replace(self, **kw) -> "Config":
        return replace(self, **kw)


# ------------------------------------------------------------- method configs
# Defaults per method, mirroring src/parsers/configs/{hands,arctic,hamer,
# handoccnet}_light.py.
# reference-exact per-method defaults (src/parsers/configs/*.py); the
# reference batch sizes are kept for parity.
_METHOD_DEFAULTS = {
    "hands_light": dict(  # configs/hands_light.py
        backbone="resnet50",
        pos_enc="center+corner_latent",
        n_freq_pos_enc=4,
        img_res=224,
        dataset="hands+assembly+epic_grasp+epic_seg",
        val_dataset="epic",
        batch_size=32,
        test_batch_size=32,
        num_workers=8,
        use_glb_feat=True,
        use_glb_feat_w_grasp=True,
        use_grasp_loss=True,
        use_render_seg_loss=True,
        use_depth_loss=False,
        eval_every_epoch=1,
        no_intrx=False,
    ),
    "arctic_sf_light": dict(  # configs/arctic_light.py: full-image inputs
        backbone="resnet50",
        pos_enc=None,
        img_res=224,
        dataset="hands+assembly+epic_grasp+epic_seg",
        val_dataset="epic",
        batch_size=32,
        test_batch_size=32,
        num_workers=8,
        no_crops=True,
        use_glb_feat=True,
        use_grasp_loss=True,
        use_render_seg_loss=True,
        eval_every_epoch=1,
    ),
    "hamer_light": dict(  # configs/hamer_light.py
        backbone="vit_h",
        pos_enc="center+corner_latent",
        n_freq_pos_enc=4,
        img_res=224,
        dataset="hands+assembly+epic_grasp+epic_seg",
        val_dataset="epic",
        batch_size=16,
        test_batch_size=16,
        num_workers=8,
        bbox_scale=2.5,
        use_glb_feat=True,
        use_grasp_loss=True,
        use_render_seg_loss=True,
        eval_every_epoch=1,
    ),
    "handoccnet_light": dict(  # configs/handoccnet_light.py
        backbone="fpn",
        pos_enc="center+corner_latent",
        n_freq_pos_enc=4,
        img_res=224,
        dataset="hands+assembly+epic_grasp+epic_seg",
        val_dataset="epic",
        batch_size=32,
        test_batch_size=32,
        num_workers=8,
        use_glb_feat=True,
        use_grasp_loss=True,
        use_render_seg_loss=True,
        eval_every_epoch=1,
    ),
}


def default_config(method: str = "hands_light", **overrides) -> Config:
    if method not in _METHOD_DEFAULTS:
        raise KeyError(
            f"unknown method '{method}'; available: {sorted(_METHOD_DEFAULTS)}"
        )
    kw = dict(_METHOD_DEFAULTS[method])
    kw["method"] = method
    kw.update(overrides)
    if kw.get("quant_int8_static"):
        # static scales live inside the int8 fused-block kernel
        kw["quant_int8"] = True
    if kw.get("quant_int8") and not kw.get("fused_block"):
        # the ViT int8 dots live inside the fused-block kernel (harmless
        # no-op for conv backbones, which quantise via ops/quant.py)
        kw["fused_block"] = True
    return Config(**kw)


def available_methods():
    return sorted(_METHOD_DEFAULTS)


# --------------------------------------------------------------- CLI parsing
def construct_args(argv=None) -> Config:
    """argparse front-end with reference-compatible flag names
    (``src/parsers/generic_parser.py``)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--method", type=str, default="hands_light")
    p.add_argument("--exp_key", type=str, default="")
    p.add_argument("--extraction_mode", type=str, default="")
    p.add_argument("--load_ckpt", type=str, default="")
    p.add_argument("--load_backbone", type=str, default="")
    p.add_argument("--resume_ckpt", type=str, default="")
    p.add_argument("--infer_ckpt", type=str, default="")
    p.add_argument("--load_from", type=str, default="")
    p.add_argument("--trainsplit", type=str, default="train",
                   choices=["train", "smalltrain", "minitrain", "tinytrain"])
    p.add_argument("--valsplit", type=str, default="minival",
                   choices=["val", "smallval", "minival", "tinyval"])
    p.add_argument("--setup", type=str, default="p2a")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--eval_every_epoch", type=int, default=5)
    p.add_argument("--lr_dec_epoch", type=int, nargs="+", default=[])
    p.add_argument("--num_epoch", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr_dec_factor", type=float, default=10.0)
    p.add_argument("--lr_decay", type=float, default=0.1)
    p.add_argument("--num_exp", type=int, default=1)
    p.add_argument("--acc_grad", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--test_batch_size", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--eval_on", type=str, default="")
    p.add_argument("--num_processes", type=int, default=1,
                   help="multi-host: total process count (1 = single-host)")
    p.add_argument("--process_id", type=int, default=0,
                   help="multi-host: this process's rank")
    p.add_argument("--coordinator_address", type=str, default="",
                   help="multi-host: host:port of process 0")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace N train steps into logs/<key>/trace")
    p.add_argument("--fused_block", action="store_true",
                   help="ViT: fused-block CUDA kernels (bf16 inference)")
    p.add_argument("--quant_int8", action="store_true",
                   help="ViT: W8A8 int8 serving dots inside the fused "
                        "block (lossy; implies --fused_block)")
    p.add_argument("--quant_int8_static", action="store_true",
                   help="ViT: static-calibrated int8 activation scales "
                        "(implies --quant_int8; run cli/calibrate first)")
    p.add_argument("--fast_gelu", action="store_true",
                   help="tanh-approx GELU (lossy serving knob)")
    p.add_argument("--mute", action="store_true")
    p.add_argument("--no_vis", action="store_true")
    p.add_argument("--cluster", action="store_true")
    p.add_argument("-f", "--fast_dev_run", action="store_true")
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)

    overrides = {}
    for f_ in dataclasses.fields(Config):
        if f_.name != "method" and hasattr(args, f_.name):
            v = getattr(args, f_.name)
            if v is None:
                continue
            if f_.name == "lr_dec_epoch":
                v = tuple(v)
            overrides[f_.name] = v

    cfg = default_config(args.method, **overrides)
    if args.debug:
        cfg = cfg.replace(
            batch_size=1, num_workers=0, trainsplit="minitrain", valsplit="minival"
        )
    elif args.fast_dev_run:
        cfg = cfg.replace(
            batch_size=8, num_workers=0, trainsplit="minitrain", valsplit="minival",
            log_every=5,
        )
    return cfg
