"""Pipeline parallelism: GPipe fill-drain over a pipe axis (port of
``hands_tpu/parallel/pipeline.py``).

S ranks, one stage each (a contiguous group of blocks), and M microbatches:
S + M - 1 ticks. At tick t stage 0 takes microbatch t while t < M; every
other stage takes what arrived from its predecessor; an activation hops
+1 a tick (``parallel/mesh.py:ppermute_raw``); the last stage keeps the
output of microbatch t - (S - 1); a sum over the ranks (zeros elsewhere)
replicates the outputs. The JAX schedule, written out.

Bubble ticks are skipped: a stage runs ``stage_fn`` only at the ticks
0 <= t - s < M where it holds a microbatch (M calls a rank; JAX's scan runs
every stage every tick on zeros), and sends zeros at the others, which no
stage uses; the hop after the last tick is not made. The outputs are the
same. Forward only, as the JAX package tests it (no pipeline gradient).
"""

from __future__ import annotations

import torch

from hands_tpu_torch.parallel.mesh import AxisGroup, ppermute_raw, sum_over


@torch.no_grad()
def pipeline_apply(stage_fn, stage_params, microbatches: torch.Tensor,
                   group: AxisGroup) -> torch.Tensor:
    """Run ``microbatches`` (M, mb, ...) through the S stages of ``group``,
    this rank's ``stage_fn(stage_params, x) -> y`` (``y.shape == x.shape``)
    being stage ``group.rank``. Returns the (M, mb, ...) outputs on every
    rank, equal to applying the S stages serially to each microbatch."""
    S, s = group.world, group.rank
    M = microbatches.shape[0]
    zero = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    buf = zero
    for t in range(S + M - 1):
        m = t - s  # the microbatch at this stage now
        y = zero
        if 0 <= m < M:
            y = stage_fn(stage_params, microbatches[m] if s == 0 else buf)
            if s == S - 1:
                outs[m] = y
        if S > 1 and t < S + M - 2:
            buf = ppermute_raw(y, group, 1)
    return sum_over(outs, group) if S > 1 else outs
