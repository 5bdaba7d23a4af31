"""The exact loss and gradient that a check holds a model's f32 gradient to.

:func:`exact_grads` runs the same model with every rounding made f64 (its
modules' dtypes, ``Tensor.float``, HandOccNet's f32 grid, new tensors'
default dtype; the skinning on its twin, since the kernel takes f32 only)
on the CPU: the exact function to f64 rounding.

The models are piecewise smooth: leaky ReLUs, ReLUs and max pools have
kinks. Where an f32 run and the f64 one fall on different sides of a kink
(a value within rounding of 0 at a ReLU, of a tie in a pool's window),
their gradients differ by a whole term on the entries behind it, however
exactly each side is computed; at two crops, HandOccNet's f32 gradient
moves by ~1e-2 of a leaf that way on most leaves. :func:`record_branches`
records the sides that a run took at every ``torch.nn.functional``
``leaky_relu``, ``relu`` and ``max_pool2d``, on any device; given them,
:func:`exact_grads` replays them, so that its gradient is the one of the
piece of the function that the run was on.
"""

from __future__ import annotations

import contextlib
import copy
from typing import List, Optional
from unittest import mock

import torch
import torch.nn.functional as F

_leaky_relu, _relu, _max_pool2d = F.leaky_relu, F.relu, F.max_pool2d


@contextlib.contextmanager
def _branches(record: List[torch.Tensor], replay: bool):
    sides = iter(record)

    def side(x: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
        got = next(sides, None)
        if got is None or got.shape != current.shape:
            raise ValueError("the replayed run took another path than the "
                             "recorded one")
        return got.to(x.device)

    # a recorded run calls the library's own function and notes the side
    def leaky_relu(x, negative_slope=0.01, inplace=False):
        if not replay:
            record.append((x > 0).cpu())
            return _leaky_relu(x, negative_slope, inplace)
        return torch.where(side(x, x > 0), x, negative_slope * x)

    def relu(x, inplace=False):
        if not replay:
            record.append((x > 0).cpu())
            return _relu(x, inplace)
        return torch.where(side(x, x > 0), x, torch.zeros_like(x))

    def max_pool2d(x, kernel_size, stride=None, padding=0, dilation=1,
                   ceil_mode=False, return_indices=False):
        out, idx = _max_pool2d(x, kernel_size, stride, padding, dilation,
                               ceil_mode, return_indices=True)
        if not replay:
            record.append(idx.cpu())
        else:
            idx = side(x, idx)
            out = x.flatten(2).gather(2, idx.flatten(2)).reshape(out.shape)
        return (out, idx) if return_indices else out

    with mock.patch.object(F, "leaky_relu", leaky_relu), \
            mock.patch.object(F, "relu", relu), \
            mock.patch.object(F, "max_pool2d", max_pool2d):
        yield
    if replay and next(sides, None) is not None:
        raise ValueError("the replayed run took fewer kinks than the "
                         "recorded one")


@contextlib.contextmanager
def record_branches():
    """Yields a list that fills with the side taken at every kink (a
    boolean mask a ReLU, the chosen indices a pool) in call order."""
    record: List[torch.Tensor] = []
    with _branches(record, replay=False):
        yield record


def f64_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` on the CPU with every parameter, buffer and
    module dtype f64."""
    m = copy.deepcopy(model).cpu().double()
    for mod in m.modules():
        if getattr(mod, "dtype", None) in (torch.float32, torch.bfloat16):
            mod.dtype = torch.float64
    return m


@contextlib.contextmanager
def f64_route():
    """Every f32 cast of a forward made f64: ``Tensor.float``, HandOccNet's
    f32 grid, new tensors' default dtype, and the skinning on its twin."""
    from hands_tpu_torch.ops import mano as manolib
    from hands_tpu_torch.ops import mano_lbs

    with mock.patch.object(manolib, "lbs_apply", mano_lbs.lbs_apply_plain), \
            mock.patch.object(torch.Tensor, "float",
                              lambda self, *a, **k: self.double()), \
            mock.patch("hands_tpu_torch.models.handoccnet_light._F32",
                       torch.float64):
        prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            yield
        finally:
            torch.set_default_dtype(prev)


def exact_grads(model, cfg, batch,
                branches: Optional[List[torch.Tensor]] = None):
    """(total loss, its loss dict, the gradient of every parameter of
    ``model`` in ``named_parameters`` order, None where unused) of the
    train step's loss in f64 on the CPU, on ``branches`` where given (from
    :func:`record_branches` around the run being checked)."""
    from hands_tpu_torch.train.step import forward_and_loss

    m = f64_copy(model)
    b64 = tuple({k: (v.double() if v.is_floating_point() else v).cpu()
                 for k, v in d.items()} for d in batch)
    pieces = (_branches(branches, replay=True) if branches is not None
              else contextlib.nullcontext())
    with f64_route(), pieces:
        total, loss_dict, _, _ = forward_and_loss(m, cfg, b64)
        grads = torch.autograd.grad(total, list(m.parameters()),
                                    allow_unused=True)
    return float(total.detach()), loss_dict, grads
