"""Sequence parallelism: token-sharded attention over a model axis (port of
``hands_tpu/parallel/sequence.py``).

Each rank holds its block of N/s query tokens, and its K and V blocks, as
(B, N/s, H, D) tensors of one process group (:class:`AxisGroup`):

- :func:`sp_attention`: K and V all-gathered once (``parallel/mesh.py:
  all_gather``), then the rank's queries against the whole sequence;
- :func:`ring_attention`: K and V blocks travel the ring, a hop of +1 a step
  (``parallel/mesh.py:ppermute``), and an online (flash-style) softmax folds
  each visiting block into the running (accumulator, max, denominator) in
  the JAX order: the rank's own block first, then the blocks of ranks r - 1,
  r - 2, ...

Both are differentiable through their collectives and equal
:func:`mha_reference` on the whole sequence up to f32 rounding. Plain
PyTorch: the JAX functions are XLA einsums, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from hands_tpu_torch.parallel.mesh import AxisGroup, all_gather, ppermute


def _attn_block(q, k, v, scale):
    """A query block against a K/V block: the unnormalised pieces of the
    online softmax, (acc (B, N, H, D), row max (B, H, N), row denominator
    (B, H, N))."""
    s = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    denom = torch.sum(p, dim=-1)
    acc = torch.einsum("bhnm,bmhd->bnhd", p, v)
    return acc, m, denom


def mha_reference(q, k, v):
    """Unsharded attention of (B, N, H, D) tensors."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v)


def sp_attention(q, k, v, group: AxisGroup):
    """This rank's queries against the whole sequence: K and V gathered
    over ``group`` along the tokens, then :func:`mha_reference`."""
    return mha_reference(q, all_gather(k, group, 1), all_gather(v, group, 1))


def ring_attention(q, k, v, group: AxisGroup):
    """Ring attention over ``group``: s - 1 hops of the K/V blocks, each
    folded into the running online softmax; full K/V is never resident.
    No causal mask (the ViT encoder is bidirectional)."""
    scale = q.shape[-1] ** -0.5
    acc, m, d = _attn_block(q, k, v, scale)
    kb, vb = k, v
    for _ in range(group.world - 1):
        kb = ppermute(kb, group, 1)
        vb = ppermute(vb, group, 1)
        acc_n, m_n, d_n = _attn_block(q, kb, vb, scale)
        m_new = torch.maximum(m, m_n)
        a = torch.exp(m - m_new)
        b = torch.exp(m_n - m_new)
        # (B, H, N) weights -> (B, N, H, 1) to scale the accumulators
        acc = (acc * a.movedim(2, 1)[..., None]
               + acc_n * b.movedim(2, 1)[..., None])
        d = d * a + d_n * b
        m = m_new
    return acc / d.movedim(2, 1)[..., None]
