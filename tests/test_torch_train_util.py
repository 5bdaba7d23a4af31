"""Shared helpers of the port's training tests (one numpy batch handed to
both packages, the relative error they state), and their own checks."""

import numpy as np
import torch

import jax.numpy as jnp

from hands_tpu.core.xdict import XDict as JaxXDict
from hands_tpu_torch.core.xdict import XDict


def both(batch_np):
    """A numpy (inputs, targets, meta_info) batch -> (JAX batch, port batch
    on the CPU)."""
    jb = tuple(JaxXDict({k: jnp.asarray(v) for k, v in d.items()})
               for d in batch_np)
    tb = tuple(XDict({k: torch.from_numpy(np.array(v)) for k, v in d.items()})
               for d in batch_np)
    return jb, tb


def rel_err(got, ref):
    """max |got - ref| / max(|ref|, 1)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)))


def test_both_hands_the_same_arrays_to_each_package():
    batch = ({"img": np.arange(6, dtype=np.float32).reshape(2, 3)},
             {"grasp.r": np.array([1, 2], np.int32)}, {})
    jb, tb = both(batch)
    assert isinstance(jb[0], JaxXDict) and isinstance(tb[0], XDict)
    np.testing.assert_array_equal(np.asarray(jb[0]["img"]),
                                  tb[0]["img"].numpy())
    assert tb[1]["grasp.r"].dtype == torch.int32
    tb[0]["img"][0, 0] = 9.0  # the port's copy is its own
    assert batch[0]["img"][0, 0] == 0.0


def test_rel_err_is_relative_above_one_and_absolute_below():
    assert rel_err([100.0, 0.5], [101.0, 0.5]) == 1.0 / 101.0
    assert rel_err([0.5], [0.25]) == 0.25
