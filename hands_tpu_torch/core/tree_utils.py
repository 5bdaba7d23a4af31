"""List, dict and tensor-list algebra (port of
``hands_tpu/core/tree_utils.py``): list-of-dicts <-> dict-of-lists,
concatenation and stacking of per-sample results, permutation undo,
chunking, row combinations, ``nanmean``, ragged padding and parameter
counts. Arrays in, numpy out, as in the JAX module; ``all_comb`` and
``nanmean`` take and return tensors."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def ld2dl(list_of_dicts: List[dict]) -> Dict[str, list]:
    """[{k: v}, ...] -> {k: [v, ...]} (keys from the first element)."""
    if not list_of_dicts:
        return {}
    return {k: [d[k] for d in list_of_dicts] for k in list_of_dicts[0]}


def dl2ld(dict_of_lists: Dict[str, list]) -> List[dict]:
    """{k: [v, ...]} -> [{k: v}, ...]."""
    keys = list(dict_of_lists)
    n = len(dict_of_lists[keys[0]])
    return [{k: dict_of_lists[k][i] for k in keys} for i in range(n)]


def cat_dl(dict_of_lists: Dict[str, list], axis: int = 0) -> dict:
    """Concatenate each list of arrays; lists of lists flatten, anything
    else stays a list."""
    out = {}
    for k, vals in dict_of_lists.items():
        if _is_array(vals[0]):
            out[k] = np.concatenate([_np(v) for v in vals], axis=axis)
        elif isinstance(vals[0], (list, tuple)):
            out[k] = [x for v in vals for x in v]
        else:
            out[k] = list(vals)
    return out


def stack_dl(dict_of_lists: Dict[str, list], axis: int = 0) -> dict:
    """Stack each list of arrays; anything else stays a list."""
    return {
        k: np.stack([_np(v) for v in vals], axis=axis)
        if _is_array(vals[0]) else list(vals)
        for k, vals in dict_of_lists.items()
    }


def prefix_dict(d: dict, prefix: str) -> dict:
    return {prefix + k: v for k, v in d.items()}


def unsort(ordered: Sequence, sort_idx: Sequence) -> list:
    """Undo a permutation: ordered[i] goes back to position sort_idx[i]."""
    out = [None] * len(ordered)
    for val, idx in zip(ordered, sort_idx):
        out[idx] = val
    return out


def chunks_by_len(lst: Sequence, n: int) -> List[list]:
    """Split into chunks of ceil(len / n): n is the chunk COUNT."""
    size = int(math.ceil(float(len(lst)) / n))
    return [list(lst[i:i + size]) for i in range(0, len(lst), size)]


def chunks_by_size(lst: Sequence, n: int) -> List[list]:
    """Split into chunks of size n."""
    return [list(lst[i:i + n]) for i in range(0, len(lst), n)]


def all_comb(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """All row combinations with the features concatenated:
    (n_x, d_x) x (n_y, d_y) -> (n_x * n_y, d_x + d_y); 1-D inputs give
    index pairs."""
    x2 = x.reshape(x.shape[0], -1)
    y2 = y.reshape(y.shape[0], -1)
    xr = torch.repeat_interleave(x2, y2.shape[0], dim=0)
    yr = y2.repeat(x2.shape[0], 1)
    return torch.cat([xr, yr], dim=1)


def nanmean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean over the finite entries; NaN where there is none."""
    mask = torch.isfinite(x)
    zeros = torch.zeros_like(x)
    if dim is None:
        s, n = torch.where(mask, x, zeros).sum(), mask.sum()
    else:
        s, n = torch.where(mask, x, zeros).sum(dim), mask.sum(dim)
    return torch.where(n > 0, s / torch.clamp(n, min=1),
                       torch.full_like(s, float("nan")))


def pad_tensor_list(tensors: List[np.ndarray]):
    """Ragged list of (Ni, ...) arrays -> padded (B, Nmax, ...) + lengths."""
    tensors = [_np(t) for t in tensors]
    lens = np.asarray([len(t) for t in tensors])
    n_max = int(lens.max())
    out = np.zeros((len(tensors), n_max) + tuple(tensors[0].shape[1:]),
                   tensors[0].dtype)
    for i, t in enumerate(tensors):
        out[i, : len(t)] = t
    return out, lens


def unpad_vtensor(padded, lengths) -> List[np.ndarray]:
    """(B, Nmax, ...) + lengths -> ragged list."""
    return [_np(padded[i][: int(n)]) for i, n in enumerate(lengths)]


def count_params(module_or_state) -> int:
    """Number of values in a module's state dict (parameters and buffers),
    or in a dict of tensors."""
    state = module_or_state.state_dict() \
        if isinstance(module_or_state, torch.nn.Module) else module_or_state
    return sum(int(np.prod(tuple(v.shape))) for v in state.values())
