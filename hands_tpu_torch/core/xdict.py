"""XDict: the batch/prediction container (port of ``hands_tpu/core/xdict.py``).

A plain ``dict`` subclass with the same collision-safe contract: silent key
overwrites are an error, ``merge`` requires disjoint key sets, and
namespacing goes through ``prefix`` / ``postfix``. Unlike the JAX version it
is not a pytree; :meth:`to_np` brings tensors to the host.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


class XDict(dict):
    """Collision-safe string-keyed container for batches and predictions."""

    def __init__(self, mydict: Mapping[str, Any] | None = None):
        """From a mapping or, as ``dict`` takes it, an iterable of (key,
        value) pairs (how ``torch.distributed`` rebuilds a dict subclass
        after it moves an FSDP module's inputs)."""
        super().__init__()
        if mydict is not None:
            pairs = mydict.items() if hasattr(mydict, "items") else mydict
            for k, v in pairs:
                super().__setitem__(k, v)

    def __setitem__(self, key: str, value: Any) -> None:
        if key in self:
            raise KeyError(
                f"XDict key '{key}' already exists"
            )
        super().__setitem__(key, value)

    def merge(self, other: Mapping[str, Any]) -> "XDict":
        """In-place union with *other*; key sets must be disjoint."""
        dup = set(self).intersection(other)
        if dup:
            raise KeyError(f"XDict merge key collision: {sorted(dup)}")
        for k, v in other.items():
            super().__setitem__(k, v)
        return self

    def prefix(self, tag: str) -> "XDict":
        return XDict({tag + k: v for k, v in self.items()})

    def postfix(self, tag: str) -> "XDict":
        return XDict({k + tag: v for k, v in self.items()})

    def to_np(self) -> "XDict":
        """Tensors -> numpy on the host (bf16 widens to f32: numpy has no
        bf16)."""

        def _np(v):
            if not isinstance(v, torch.Tensor):
                return v
            v = v.detach().cpu()
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()

        return XDict({k: _np(v) for k, v in self.items()})


# host-only bookkeeping of a loader's meta_info (strings, python ints)
HOST_ONLY_KEYS = ("imgname", "num_valid", "dataset_name")


def device_view(meta: "XDict") -> "XDict":
    """``meta`` without the host-only bookkeeping keys: what a step takes."""
    return XDict({k: v for k, v in meta.items() if k not in HOST_ONLY_KEYS})
