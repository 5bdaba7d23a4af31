"""Learning check: does training learn? (the port's version of the
learning leg of ``scripts/chip_numerics_check.py``).

WildHands (ResNet-18, render, grasp and global features off, bf16, lr
3e-4) overfits one synthetic batch of 16 (``data/synthetic.make_batch``,
seed 0) through GT processing, the model, the flag-gated losses, the
gradient clip and Adam: ``--steps`` train steps, then one eval step. The
total loss must fall by more than 10x and ``pix_err`` must be finite.

    python -m hands_tpu_torch.cli.numerics_check [--steps 300]
    python -m hands_tpu_torch.cli.numerics_check --steps 2 --device cpu

Prints ``loss0 -> loss1``, the ms a step (host clock around the steps,
ending in a synchronise) and ``pix_err``, on the card the device's busy
share over 10 further steps, then one JSON line of the same; exits 1 when
the loss did not fall 10x.
The JAX script's two other legs convert the upstream project's torch models,
which are not in the repository; they are not ported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

BATCH = 16
SEED = 0
BUSY_STEPS = 10  # further steps the card's busy share is read over


def learning_config():
    """The JAX leg's configuration."""
    from hands_tpu_torch.config import default_config

    return default_config("hands_light", backbone="resnet18",
                          use_render_seg_loss=False, use_grasp_loss=False,
                          use_glb_feat=False, lr=3e-4)


def learning_check(steps: int = 300, device="cuda") -> dict:
    """Train ``steps`` steps on one batch and evaluate it. Returns loss0
    (the first step's loss), loss1 (the last step's), ms a step over steps
    2..n, pix_err (px, mean over hands), the per-step losses and
    ``train_steps``, the steps taken in all; raises AssertionError unless
    loss1 is finite and below loss0 / 10. On the card, ``busy_share`` is
    the device's busy time over the wall time of ``BUSY_STEPS`` further
    steps (``torch.profiler``, which takes them twice), after the check's
    numbers are read."""
    from hands_tpu_torch.core.xdict import device_view
    from hands_tpu_torch.data.synthetic import make_batch
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_eval_step, make_train_step

    cfg = learning_config()
    inputs, targets, meta = make_batch(cfg, BATCH, seed=SEED, device=device)
    batch = (inputs, targets, device_view(meta))
    model = fetch_model(cfg, device=device, seed=SEED)
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    state, logs = step(state, batch, gen)
    losses = [logs["loss"]]
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, logs = step(state, batch, gen)
        losses.append(logs["loss"])
    sync()
    ms = (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3
    losses = [float(v) for v in torch.stack(losses).cpu()]
    metrics, _ = make_eval_step(model, cfg)(state, batch)
    pix = float(np.nanmean(metrics["pix_err/h"].float().cpu().numpy()))
    out = {"loss0": losses[0], "loss1": losses[-1], "steps": steps,
           "batch": BATCH, "ms_per_step": ms, "pix_err": pix,
           "losses": losses, "train_steps": steps, "busy_share": None}
    print(f"learning check: loss {losses[0]:.1f} -> {losses[-1]:.2f} in "
          f"{steps} steps bs{BATCH} ({ms:.2f} ms a step), pix_err {pix:.1f} "
          f"px")
    if torch.device(device).type == "cuda":
        from hands_tpu_torch.utils.profiling import device_busy_ms

        def more():
            for _ in range(BUSY_STEPS):
                step(state, batch, gen)

        busy_ms, _ = device_busy_ms(more)
        t0 = time.perf_counter()
        more()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        out["train_steps"] += 3 * BUSY_STEPS
        if busy_ms is not None:
            out["busy_share"] = busy_ms / wall_ms
            print(f"  {BUSY_STEPS} further steps: device busy {busy_ms:.1f} "
                  f"of {wall_ms:.1f} ms ({100 * out['busy_share']:.1f}%)")
    assert np.isfinite(out["loss1"]) and out["loss1"] < out["loss0"] / 10, (
        out["loss0"], out["loss1"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    try:
        out = learning_check(args.steps, args.device)
    except AssertionError as err:
        print(f"learning check FAILED: loss did not fall 10x {err}")
        return 1
    print(json.dumps({k: v for k, v in out.items() if k != "losses"}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
