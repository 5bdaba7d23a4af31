"""Where a train step's time goes (the H100 version of
``scripts/train_decompose.py``): HaMeR ViT-H at 32 images and WildHands at
64, on seeded random weights and one synthetic batch.

    python -m hands_tpu_torch.cli.train_decompose                  # both
    python -m hands_tpu_torch.cli.train_decompose --method hamer_light \\
        --batch 32 --iters 10 --json rows.json
    python -m hands_tpu_torch.cli.train_decompose --device cpu --vit tiny \\
        --backbone resnet18 --batch 2 --img_res 64     # a small CPU run

Measured rows (each timed ``--iters`` times after a warm-up call, by CUDA
events on the card, by the host clock with ``--device cpu``; on the card
each row also carries its device time, ``utils.profiling.device_busy_ms``,
and the share of the row the card sat idle):

  gt_process   ``train/process.py``: the ground truth's MANO pass
  fwd_eval     GT processing, forward and losses in eval mode, no gradient
  fwd_train    the same in train mode, the autograd graph recorded
  grad         ``train/step.py:loss_and_grads``: fwd_train and the backward
  opt_only     ``train/state.py``'s optimiser on gradients made beforehand
  full_step    ``train/step.py:make_train_step``'s step
  trunk_grad   the backbone alone, forward and backward of a sum of squares
               of its features (HaMeR: the ViT with K4, then the plain block
               with ``torch.utils.checkpoint`` (``trunk_grad_ckpt``) and
               without (``trunk_grad_plain``), and without its blocks,
               ``trunk_no_blocks``: the patch embedding and the last
               LayerNorm; WildHands: both ResNets)

Derived rows (from the medians): the backward (grad - fwd_train); the
recompute (K4: K3's kernels' device time in grad less that in fwd_train;
the plain block: ckpt - plain); the blocks (trunk_grad - trunk_no_blocks);
and the step outside the blocks or backbones: heads and losses (grad -
trunk_grad - gt_process), GT processing, the optimiser and the patch
embedding. These add up to grad + opt_only; what ``full_step`` takes beyond
that by more than the runs' spread is printed as a gap (the step's own
gradient norm for the logs lies there). WildHands adds K1's and K2's share
of the step's device time.

There is no fallback: ``--device cuda`` (the default) without a card raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

# K3's kernels, by the profiler's names (K4's recompute runs them)
K3_KERNELS = ("layernorm_kernel", "BlockEpilogue", "attention_mma_kernel")


class Setup:
    """A model, its train state, one synthetic batch and the dropout
    generator, on one device."""

    def __init__(self, method: str, batch: int, device, seed: int = 0,
                 vit: str = "h", backbone: str = "resnet50",
                 img_res: Optional[int] = None, overrides=None):
        from hands_tpu_torch.config import default_config
        from hands_tpu_torch.data.synthetic import make_batch
        from hands_tpu_torch.models.registry import fetch_model
        from hands_tpu_torch.train.state import create_train_state

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("train_decompose: no CUDA device (pass "
                               "--device cpu to run on the CPU)")
        # lr 1e-6: the timed steps barely move the weights, so every row
        # sees the model of the first (K2's work depends on where the hands
        # land in the render)
        if method == "hamer_light":
            # phase 7 of chip_smoke.py: bf16, K4, grasp loss on, mask off
            kw = dict(compute_dtype="bfloat16", fused_block=True,
                      use_render_seg_loss=False, lr=1e-6)
        elif method == "hands_light":
            # the default train config: bf16, grasp and mask loss on
            kw = dict(backbone=backbone, lr=1e-6)
        else:
            raise ValueError(f"unknown method {method!r}")
        if img_res is not None:
            kw.update(img_res=img_res, img_res_ds=img_res)
        kw.update(overrides or {})  # Config fields set from Python
        self.method = method
        self.cfg = default_config(method, **kw)
        self.model = fetch_model(self.cfg, device=self.device, seed=seed,
                                 vit_variant=vit, param_dtype=torch.float32)
        self.batch = make_batch(self.cfg, batch, seed=seed,
                                device=self.device)
        self.state = create_train_state(self.cfg, self.model)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.batch_size = batch
        self.trunks = self._trunks(seed)

    def _trunks(self, seed):
        """[(backbone module, an input of the shape the step gives it)]."""
        net = self.model.net
        B = self.batch_size
        g = torch.Generator(device=self.device).manual_seed(seed + 1)

        def draw(*shape, dtype):
            return torch.randn(shape, generator=g, device=self.device).to(
                dtype)

        if self.method == "hamer_light":
            # the two crops of every image, resized to the ViT's input
            return [(net.backbone, draw(2 * B, 256, 192, 3,
                                        dtype=net.dtype))]
        out = []
        if net.glb_backbone is not None:
            res = self.cfg.img_res
            out.append((net.glb_backbone, draw(B, res, res, 3,
                                               dtype=net.dtype)))
        res = self.cfg.img_res_ds
        hands = ([net.backbone_r, net.backbone_l] if self.cfg.separate_hands
                 else [net.hand_backbone])
        for m in hands:
            c_in = m.conv_stem.weight.shape[1]
            n = B if self.cfg.separate_hands else 2 * B
            out.append((m, draw(n, res, res, c_in, dtype=net.dtype)))
        return out


@contextlib.contextmanager
def block_form(backbone, fused: bool, checkpoint: bool = False,
               blocks: bool = True):
    """The ViT's blocks as K4 (``fused``) or the plain block, under
    ``torch.utils.checkpoint`` or not; ``blocks=False`` drops them."""
    saved = ([(b.fused, b.fused_train) for b in backbone.blocks],
             backbone.use_checkpoint, backbone.blocks)
    for b in backbone.blocks:
        b.fused = b.fused_train = fused
    backbone.use_checkpoint = checkpoint
    if not blocks:
        backbone.blocks = torch.nn.ModuleList()
    try:
        yield
    finally:
        flags, backbone.use_checkpoint, backbone.blocks = saved
        for b, (f, ft) in zip(backbone.blocks, flags):
            b.fused, b.fused_train = f, ft


def pieces(s: Setup) -> Dict[str, Callable]:
    """The measured rows as callables (each returns what it computed)."""
    from hands_tpu_torch.core.precision import f32_matmuls
    from hands_tpu_torch.train.process import process_data_light
    from hands_tpu_torch.train.step import (forward_and_loss, loss_and_grads,
                                            make_train_step)

    model, cfg, batch, gen = s.model, s.cfg, s.batch, s.gen
    step = make_train_step(model, cfg)

    @f32_matmuls
    def gt_process():
        inputs, targets, meta = batch
        return process_data_light(model.mano_r.model, model.mano_l.model,
                                  inputs, targets, meta, cfg.img_res)

    @torch.no_grad()
    @f32_matmuls
    def fwd_eval():
        model.eval()
        return forward_and_loss(model, cfg, batch)[0]

    @f32_matmuls
    def fwd_train():
        model.train()
        return forward_and_loss(model, cfg, batch, gen)[0]

    @f32_matmuls
    def grad():
        return loss_and_grads(model, cfg, s.state.params, batch, gen)

    @f32_matmuls
    def trunk_grad():
        model.train()
        total = sum((m(x).float() ** 2).sum() for m, x in s.trunks)
        params = [p for m, _ in s.trunks for p in m.parameters()]
        return torch.autograd.grad(total, params, allow_unused=True)

    out = {"gt_process": gt_process, "fwd_eval": fwd_eval,
           "fwd_train": fwd_train, "grad": grad,
           "full_step": lambda: step(s.state, batch, gen)[1]["loss"],
           "trunk_grad": trunk_grad}
    if s.method == "hamer_light":
        bb = model.net.backbone
        fused = bb.blocks[0].fused_train

        def form(**kw):
            def run():
                with block_form(bb, **kw):
                    return trunk_grad()
            return run

        out["trunk_grad"] = form(fused=fused)
        out["trunk_grad_ckpt"] = form(fused=False, checkpoint=True)
        out["trunk_grad_plain"] = form(fused=False)
        out["trunk_no_blocks"] = form(fused=fused, blocks=False)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_row(fn: Callable, iters: int, device) -> list:
    """ms of each of ``iters`` calls after a warm-up call: CUDA events on
    the card (the row's wall time on the card's timeline), the host clock
    otherwise."""
    out = fn()
    _sync(device)
    del out
    ms = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        del out
    return ms


def measure(s: Setup, iters: int, rows=None) -> dict:
    """Every row of :func:`pieces` (or the named ``rows``): {"ms": [...],
    "median", "min", "max", "device_ms", "parts": {name: device ms}}. All
    rows are timed first, then (on the card) profiled, so that the profiler
    never runs before a timed call."""
    from hands_tpu_torch.utils.profiling import device_busy_ms

    fns = pieces(s)
    names = list(rows or fns)
    if rows is None:  # the optimiser is timed right after grad
        names.insert(names.index("grad") + 1, "opt_only")
    if "opt_only" in names:
        # the optimiser on gradients of this batch, made beforehand
        grads = fns["grad"]()[2]
        fns["opt_only"] = lambda: s.state.apply_gradients(grads)
    ms = {name: time_row(fns[name], iters, s.device) for name in names}
    parts = {"hamer_light": K3_KERNELS, "hands_light": ("lbs", "splat")}
    result = {}
    for name in names:
        busy, part = ((None, {}) if s.device.type != "cuda" else
                      device_busy_ms(fns[name], parts[s.method]))
        result[name] = _row(ms[name], busy, part)
    return result


def _row(ms, busy, part):
    return {"ms": ms, "median": float(np.median(ms)), "min": min(ms),
            "max": max(ms), "device_ms": busy, "parts": part}


def derive(method: str, rows: dict) -> dict:
    """The derived rows (medians) and the check against ``full_step``:
    {"rows": {name: ms or None}, "sum": ms, "spread": ms, "gap": ms or
    None}."""
    med = {k: r["median"] for k, r in rows.items()}
    d = {"backward": med["grad"] - med["fwd_train"]}
    outside = {"GT processing": med["gt_process"],
               "optimiser": med["opt_only"]}
    if method == "hamer_light":
        k3_grad = rows["grad"]["parts"].get(K3_KERNELS[0])
        if rows["grad"]["device_ms"] is not None and k3_grad is not None:
            k3 = lambda r: sum(rows[r]["parts"].values())  # noqa: E731
            d["recompute (K4, device)"] = k3("grad") - k3("fwd_train")
        else:
            d["recompute (K4, device)"] = None
        d["recompute (plain block + checkpoint)"] = (
            med["trunk_grad_ckpt"] - med["trunk_grad_plain"])
        d["blocks (forward and backward)"] = (
            med["trunk_grad"] - med["trunk_no_blocks"])
        outside["patch embedding"] = med["trunk_no_blocks"]
        trunk = med["trunk_grad"]
        outside["heads and losses"] = med["grad"] - trunk - med["gt_process"]
        d["outside the blocks"] = (med["full_step"]
                                   - d["blocks (forward and backward)"])
        inside = d["blocks (forward and backward)"]
    else:
        trunk = med["trunk_grad"]
        outside["heads and losses"] = med["grad"] - trunk - med["gt_process"]
        d["backbones (forward and backward)"] = trunk
        d["outside the backbones"] = med["full_step"] - trunk
        inside = trunk
        step = rows["full_step"]
        if step["device_ms"] is not None:
            for name, key in (("K1", "lbs"), ("K2", "splat")):
                ms = step["parts"].get(key, 0.0)
                d[f"{name} device ms"] = ms
                d[f"{name} share of the step's device time"] = (
                    ms / step["device_ms"])
    for k, v in outside.items():
        d[f"outside: {k}"] = v
    total = inside + sum(outside.values())
    spread = sum(rows[k]["max"] - rows[k]["min"]
                 for k in ("grad", "opt_only", "full_step"))
    gap = med["full_step"] - total
    return {"rows": d, "sum": total, "spread": spread,
            "gap": None if abs(gap) <= spread else gap}


def report(method: str, batch: int, rows: dict, derived: dict,
           where: str) -> None:
    clock = "CUDA events" if "cuda" in where else "host clock"
    print(f"== {method} train step, {batch} images: ms by {clock} "
          f"(median, min-max of {len(next(iter(rows.values()))['ms'])}) "
          f"[{where}] ==")
    for name, r in rows.items():
        if r["device_ms"] is None:
            dev = "device not measured"
        else:
            dev = (f"device {r['device_ms']:.2f} ms "
                   f"({1 - r['device_ms'] / r['median']:.1%} idle)")
        print(f"  {name:18s} {r['median']:9.2f} ms ({r['min']:.2f}-"
              f"{r['max']:.2f}); {dev}")
    for name, v in derived["rows"].items():
        if v is None:
            print(f"  = {name}: not measured")
        elif "share" in name:
            print(f"  = {name}: {v:.1%}")
        else:
            print(f"  = {name}: {v:.2f} ms")
    print(f"  = the rows add up to {derived['sum']:.2f} ms against "
          f"full_step {rows['full_step']['median']:.2f} ms (spread "
          f"{derived['spread']:.2f} ms)")
    if derived["gap"] is not None:
        print(f"  gap: {derived['gap']:.2f} ms of full_step is in no row "
              f"(beyond the runs' spread)")


def where_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    import subprocess

    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        card = torch.cuda.get_device_name(device)
    return card


def run(method: str, batch: int, iters: int, device, seed: int = 0,
        vit: str = "h", backbone: str = "resnet50",
        img_res: Optional[int] = None, overrides=None) -> dict:
    """Build, measure, derive and print one decomposition; returns
    {"method", "batch", "where", "rows", "derived"}."""
    s = Setup(method, batch, device, seed, vit, backbone, img_res, overrides)
    rows = measure(s, iters)
    derived = derive(method, rows)
    where = where_line(s.device)
    report(method, batch, rows, derived, where)
    del s
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"method": method, "batch": batch, "where": where, "rows": rows,
            "derived": derived}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--method", default="both",
                   choices=["both", "hamer_light", "hands_light"])
    p.add_argument("--batch", type=int, default=0,
                   help="images a step (default: 32 HaMeR, 64 WildHands)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--vit", default="h", help="HaMeR's ViT variant")
    p.add_argument("--backbone", default="resnet50",
                   help="WildHands' backbone")
    p.add_argument("--img_res", type=int, default=None,
                   help="image and crop side (default: the config's)")
    p.add_argument("--json", default="", help="write the rows there")
    args = p.parse_args(argv)
    methods = (["hamer_light", "hands_light"] if args.method == "both"
               else [args.method])
    out = [run(m, args.batch or {"hamer_light": 32, "hands_light": 64}[m],
               args.iters, args.device, vit=args.vit,
               backbone=args.backbone, img_res=args.img_res)
           for m in methods]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
