"""Port parity of ``train/state.py``: the optimiser against the JAX
package's optax chain (global-norm clip at 150 -> Adam under the piecewise
schedule, inside ``MultiSteps`` when ``acc_grad > 1``), with gradients fed
from numpy to both sides, five steps and more.

Tolerance: every parameter after every step within 1e-6 absolute (parameters
of unit scale, updates of ``lr`` each).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from hands_tpu.config import default_config as jax_config
from hands_tpu.train.state import make_optimizer as jax_make_optimizer
from hands_tpu_torch.config import default_config
from hands_tpu_torch.train.state import (create_train_state, global_norm,
                                         make_optimizer)

SHAPES = {"a": (7, 5), "b": (11,), "c": (3, 2, 4)}
TOL = 1e-6


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step, scale):
    rng = np.random.RandomState(100 + step)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run(cfg_kw, scales, steps_per_epoch=1000):
    """Feed the same gradients to optax and to the port; yields
    (step, JAX params, port params, port optimiser)."""
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    tx = jax_make_optimizer(jax_config("hands_light", **cfg_kw),
                            steps_per_epoch)
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(v.copy()) for v in _params().values()]
    opt = make_optimizer(default_config("hands_light", **cfg_kw), tp,
                         steps_per_epoch)
    for i, scale in enumerate(scales):
        g = _grads(i, scale)
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update([torch.from_numpy(v) for v in g.values()])
        yield i, jp, dict(zip(SHAPES, tp)), opt


def _assert_params_close(jp, tp):
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=TOL, err_msg=k)


def _norm(scale, step=0):
    return float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in _grads(step, scale).values())))


@pytest.mark.parametrize("scale", [1.0, 40.0], ids=["below_clip", "above_clip"])
def test_adam_and_clip_match_optax(scale):
    assert (_norm(scale) >= 150.0) == (scale > 1.0)
    start = _params()
    for i, jp, tp, opt in _run(dict(lr=1e-3), [scale] * 5):
        _assert_params_close(jp, tp)
        assert opt.count == i + 1
    assert np.abs(tp["a"].numpy() - start["a"]).max() > 3e-3  # it moved


def test_clip_changes_the_update_only_above_the_norm():
    """Adam is scale-free but for eps, so feed one large step between small
    ones: the moments remember the clipped magnitude."""
    for _, jp, tp, _ in _run(dict(lr=1e-3), [1.0, 40.0, 1.0, 0.01, 40.0, 1.0]):
        _assert_params_close(jp, tp)
    for _, jp, tp, _ in _run(dict(lr=1e-3, grad_clip=1.0), [1.0] * 5):
        _assert_params_close(jp, tp)


def test_multisteps_accumulation_matches_optax():
    """acc_grad=2: parameters and Adam's count move on every second
    micro-step only, by the clipped mean of the two gradients."""
    prev = {k: torch.from_numpy(v) for k, v in _params().items()}
    for i, jp, tp, opt in _run(dict(lr=1e-3, acc_grad=2),
                               [1.0, 60.0, 1.0, 1.0, 60.0, 60.0, 1.0, 1.0,
                                1.0, 1.0]):
        _assert_params_close(jp, tp)
        assert opt.count == (i + 1) // 2
        moved = any(not torch.equal(tp[k], prev[k]) for k in SHAPES)
        assert moved == (i % 2 == 1), i
        prev = {k: v.clone() for k, v in tp.items()}


def test_piecewise_schedule_matches_optax():
    """lr_dec_epoch=(2, 4) with 2 steps per epoch: lr / 10 from update 4 on,
    lr / 100 from update 8 on."""
    kw = dict(lr=1e-2, lr_dec_epoch=(2, 4), lr_dec_factor=10.0)
    seen = []
    for i, jp, tp, opt in _run(kw, [1.0] * 10, steps_per_epoch=2):
        _assert_params_close(jp, tp)
        seen.append(opt.learning_rate(i))
    np.testing.assert_allclose(seen, [1e-2] * 4 + [1e-3] * 4 + [1e-4] * 2,
                               rtol=1e-12)


def test_schedule_counts_updates_under_accumulation():
    kw = dict(lr=1e-2, lr_dec_epoch=(1,), acc_grad=2)
    for i, jp, tp, opt in _run(kw, [1.0] * 8, steps_per_epoch=2):
        _assert_params_close(jp, tp)
    assert opt.count == 4 and opt.learning_rate() == pytest.approx(1e-3)


def test_global_norm_and_train_state():
    g = [torch.from_numpy(v) for v in _grads(0, 3.0).values()]
    assert float(global_norm(g)) == pytest.approx(_norm(3.0), rel=1e-6)
    model = torch.nn.Linear(4, 3)
    state = create_train_state(default_config("hands_light", lr=0.1), model)
    before = model.weight.detach().clone()
    out = state.apply_gradients([torch.ones_like(p) for p in state.params])
    assert out is state and state.step == 1 and state.tx.count == 1
    # the first Adam update is -lr * sign(g), in place on the model
    torch.testing.assert_close(model.weight.detach(), before - 0.1,
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="param_dtype"):
        create_train_state(default_config("hands_light"),
                           torch.nn.Linear(4, 3).to(torch.bfloat16))
