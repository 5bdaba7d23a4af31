"""Recursive container conversions (port of ``hands_tpu/core/thing.py``).
"Things" are arbitrary nests of dict/list/tuple holding tensors or numpy
arrays."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _map(thing: Any, fn) -> Any:
    if isinstance(thing, dict):
        return type(thing)({k: _map(v, fn) for k, v in thing.items()})
    if isinstance(thing, (list, tuple)):
        return type(thing)(_map(v, fn) for v in thing)
    return fn(thing)


def thing2np(thing: Any) -> Any:
    return _map(thing, lambda v: v.detach().cpu().numpy()
                if isinstance(v, torch.Tensor) else v)


def thing2torch(thing: Any) -> Any:
    """numpy leaves -> tensors (the JAX module's ``thing2jax``)."""
    return _map(thing, lambda v: torch.from_numpy(v)
                if isinstance(v, np.ndarray) else v)


def thing2list(thing: Any) -> Any:
    return _map(thing, lambda v: v.tolist() if hasattr(v, "tolist") else v)


def detach_thing(thing: Any) -> Any:
    """Stop gradients on every tensor leaf."""
    return _map(thing, lambda v: v.detach()
                if isinstance(v, torch.Tensor) else v)


def thing_to_dev(thing: Any, device) -> Any:
    def fn(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        return v.to(device) if isinstance(v, torch.Tensor) else v

    return _map(thing, fn)
