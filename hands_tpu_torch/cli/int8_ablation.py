"""Knock-out timing of the static W8A8 ViT block at ViT-H serving shapes
(port of ``scripts/vith_int8_ablation.py``'s ``main``).

Times every mode of :mod:`hands_tpu_torch.ops.vit_block_ablation` on one
block (1280 wide, 16 heads of 80, 192 tokens, hidden 5120; ``--batch`` crops)
and prints ``ms/block`` per mode and the attribution ``full - variant``: what
each knocked-out piece costs. Weights and tokens come from
``np.random.RandomState(0)`` in the JAX script's order and distribution, the
activation scales are its fixed probe scales, and the tanh GELU is on, as
there.

    python -m hands_tpu_torch.cli.int8_ablation [--batch 256] [--iters 30]
        [--modes full no_ln ...] [--device cuda]

On the card the times are CUDA-event times of the kernels; ``--device cpu``
runs the plain twins (for tests: take a small ``--batch``) and reads the
host's clock. The JAX script's ``--tiles`` has no counterpart: there the block
is one kernel tiled over the batch, here it is a sequence of launches over
all rows, so there is no tile to choose.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hands_tpu_torch.ops import quant
from hands_tpu_torch.ops.vit_block_ablation import MODES, vit_block_ablation

C, HEADS, HIDDEN, N_TOK = 1280, 16, 5120, 192  # ViT-H, 256x192 crops / 16
# plausible calibrated scales (the values move clipping, not time)
PROBE_SCALES = {"qkv": 4.0 / 127, "proj": 2.0 / 127, "mlp1": 4.0 / 127,
                "mlp2": 2.0 / 127}


def make_params(rng: np.random.RandomState, c: int, hidden: int
                ) -> Dict[str, torch.Tensor]:
    """The probe's block parameters, drawn as the JAX script draws them
    ((in, out) matrices of std 0.03, in the order qkv, proj, MLP1, MLP2) and
    returned in the port's (out, in) layout."""
    def mat(n_in, n_out):
        return torch.from_numpy(
            (rng.randn(n_in, n_out) * 0.03).astype(np.float32).T.copy())

    wqkv, wproj = mat(c, 3 * c), mat(c, c)
    w1, w2 = mat(c, hidden), mat(hidden, c)
    return {
        "ln1_scale": torch.ones(c), "ln1_bias": torch.zeros(c),
        "wqkv": wqkv, "bqkv": torch.zeros(3 * c),
        "wproj": wproj, "bproj": torch.zeros(c),
        "ln2_scale": torch.ones(c), "ln2_bias": torch.zeros(c),
        "w1": w1, "b1": torch.zeros(hidden),
        "w2": w2, "b2": torch.zeros(c),
    }


def make_probe(batch: int, device, c: int = C, hidden: int = HIDDEN,
               n_tok: int = N_TOK, seed: int = 0):
    """(x (batch, n_tok, c) bf16, the folded static operands) on ``device``."""
    rng = np.random.RandomState(seed)
    params = make_params(rng, c, hidden)
    x = torch.from_numpy(
        (rng.randn(batch, n_tok, c) * 0.5).astype(np.float32)).to(
            torch.bfloat16)
    sizes = {"qkv": c, "proj": c, "mlp1": c, "mlp2": hidden}
    scales = {k: torch.full((sizes[k],), v, dtype=torch.float32)
              for k, v in PROBE_SCALES.items()}
    op = quant.fold_static_scales(params, scales)
    return x.to(device), {k: v.to(device) for k, v in op.items()}


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after one warm-up call: CUDA
    events on the card, the host's clock on the CPU."""
    fn()
    if device.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def run_ablation(batch: int = 256, iters: int = 30,
                 modes: Sequence[str] = MODES, device="cuda",
                 probe=None, heads: int = HEADS, out=print
                 ) -> Dict[str, float]:
    """Time each mode on one block; prints as the JAX script does and returns
    {mode: ms/block}. ``probe`` replaces :func:`make_probe`'s (x, operands)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    x, op = probe if probe is not None else make_probe(batch, device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU twins, host clock")
    out(f"device: {where}; rows {x.shape[0] * x.shape[1]}, C {x.shape[2]}")
    results: Dict[str, float] = {}
    with torch.no_grad():
        for mode in modes:
            results[mode] = time_ms(
                lambda: vit_block_ablation(x, op, num_heads=heads, mode=mode,
                                           fast_gelu=True), iters, device)
            out(f"{mode:12s}: {results[mode]:8.3f} ms/block")
    base = results.get("full")
    if base is not None:
        out("\nattribution (full - variant, ms):")
        for mode, ms in results.items():
            if mode != "full":
                out(f"  {mode:12s}: {base - ms:+7.3f}")
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--modes", nargs="+", default=MODES, choices=MODES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run_ablation(args.batch, args.iters, args.modes, args.device)


if __name__ == "__main__":
    main()
