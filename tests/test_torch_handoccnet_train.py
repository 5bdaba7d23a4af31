"""Port parity of one HandOccNet train step
(``hands_tpu_torch.models.handoccnet_light``), as
``tests/test_train_other_families.py`` runs it: B = 1, ``img_res`` 160,
f32, grasp and render losses off; every Flax leaf a numpy draw carried by
``utils.from_jax``.

The loss terms and gradients are taken with the running statistics on both
sides (JAX ``_forward_and_loss(train=False)`` under ``jax.grad``, the port
model in eval mode). With batch statistics the function is ill-conditioned
at this batch: the hourglass's deepest level normalises 1 x 1 maps over the
two crops, and the JAX model's own train-mode output moves by 2e-2 of its
scale under a 1e-6 relative change of the input (2e-6 with the running
statistics). The train-mode step is held where it is well conditioned: the
stem BatchNorm's new running statistics against Flax's ``batch_stats``.

The gradients are held to the JAX model's in f64 (``jax.grad`` under
``jax.enable_x64`` with every ``jnp.float32`` of its forward and loss made
f64, the same numpy weights): the exact function, computed without the
port. The port's own f64 route (``utils/exact.py``) must match it on every
leaf within F64_LEAF of the leaf's largest entry (observed 7.9e-13), and
its loss terms likewise. The port's f32 gradient is then held to the port's
f64 gradient on the branches the f32 run took (``record_branches``): the
model is piecewise smooth (leaky ReLUs, max pools), and where the f32 run
lies on another side of a kink than the f64 one the two gradients differ
by a whole term however exact each is, ~1e-2 of a leaf on most leaves at
this size. On its own branches every leaf is within F32_LEAF (observed
4.1e-4, the FPN's first blocks) and the median over the leaves within
F32_MEDIAN (observed 4.8e-6). Leaves whose exact gradient is zero by a
shift invariance (the key biases of the FIT/SET attentions, the heatmap
score's bias) are held below F64_LEAF of the model's largest gradient
entry in f64 on both sides and below 1e-5 of it in f32.

Tolerances otherwise: the f32 loss terms 1e-5 relative to max(|ref|, 1e-3)
of the JAX model's in f32; the running statistics 1e-5 absolute.
"""

import copy
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch as jax_make_batch
from hands_tpu.models.registry import fetch_model as jax_fetch_model
from hands_tpu.train import step as jstep
from hands_tpu_torch.config import default_config
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.train import step as tstep
from hands_tpu_torch.train.state import create_train_state
from hands_tpu_torch.utils.exact import exact_grads, f64_copy, record_branches
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_hands_light import fill_variables
from test_torch_train_util import both

KW = dict(compute_dtype="float32", use_grasp_loss=False,
          use_render_seg_loss=False, img_res=160, img_res_ds=160)
SHIFT_INVARIANT = (".encode_key.bias", "regressor.score.bias")
F64_LEAF, F32_LEAF, F32_MEDIAN = 1e-10, 1e-3, 5e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree, dtype=np.float32):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype), tree)


@pytest.fixture(scope="module")
def step():
    jcfg = jax_config("handoccnet_light", **KW)
    tcfg = default_config("handoccnet_light", **KW)
    jb, tb = both(jax_make_batch(jcfg, 1, seed=0, np_arrays=True))
    jmodel = jax_fetch_model(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jb[0], jb[2]))
    variables = _np(fill_variables(shapes, 1))

    def loss_fn(params, batch_stats, batch, train):
        total, (loss_dict, _, _, new_bs) = jstep._forward_and_loss(
            jmodel, jcfg, params, batch_stats, batch,
            jax.random.PRNGKey(1), train=train)
        return total, ({k: v for k, (v, _) in loss_dict.items()}, new_bs)

    # the JAX model in f64: every f32 of its forward and loss made f64
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        v64 = _np(variables, np.float64)
        jb64 = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64) if a.dtype == np.float32 else a,
            jb)
        gref, (lref64, _) = jax.jit(jax.grad(
            lambda p: loss_fn(p, v64["batch_stats"], jb64, False),
            has_aux=True))(v64["params"])
    # in f32: the loss terms with the running statistics, and the batch
    # statistics of a train-mode forward
    lref, new_bs = jax.jit(lambda p: (
        loss_fn(p, variables["batch_stats"], jb, False)[1][0],
        loss_fn(p, variables["batch_stats"], jb, True)[1][1]))(
            variables["params"])

    model = fetch_model(tcfg, "cpu")
    model.load_state_dict(state_dict_from_jax(variables, model))
    named = dict(model.named_parameters())
    want = state_dict_from_jax({"params": _np(gref, np.float64),
                                "batch_stats": v64["batch_stats"]},
                               f64_copy(model))
    with record_branches() as sides:
        total, loss_dict, _, _ = tstep.forward_and_loss(model, tcfg, tb)
        grads = torch.autograd.grad(total, list(named.values()),
                                    allow_unused=True)
    _, free_terms, free = exact_grads(model, tcfg, tb)
    _, _, own = exact_grads(model, tcfg, tb, sides)
    return dict(tcfg=tcfg, tb=tb, model=model, lref=lref, lref64=lref64,
                free_terms=free_terms, new_bs=new_bs,
                want=want, loss_dict=loss_dict, grads=dict(zip(named, grads)),
                free=dict(zip(named, free)), own=dict(zip(named, own)))


def test_loss_terms_match_jax(step):
    for ref, got, rel in ((step["lref"], step["loss_dict"], 1e-5),
                          (step["lref64"], step["free_terms"], F64_LEAF)):
        assert set(got) == set(ref) and len(ref) == 11
        for k, v in ref.items():
            a = float(v)
            assert abs(float(got[k][0].detach()) - a) <= rel * max(abs(a),
                                                                   1e-3), k


def test_gradients_match_jax_to_f32_resolution(step):
    grads, want = step["grads"], step["want"]
    free, own = step["free"], step["own"]
    top = max(float(want[n].abs().max()) for n in grads)
    dist = {}
    for name, g in grads.items():
        ref = want[name]
        if ".smooth2." in name:
            # p3's smoothing feeds nothing: zero in JAX, unused here
            assert g is None and free[name] is None and not ref.any(), name
            continue
        if name.endswith(SHIFT_INVARIANT):
            assert float(free[name].abs().max()) <= F64_LEAF * top, name
            assert float(ref.abs().max()) <= F64_LEAF * top, name
            assert float(g.abs().max()) <= 1e-5 * top, name
            continue
        scale = float(ref.abs().max())
        # the port's function is JAX's: both in f64
        assert float((free[name] - ref).abs().max()) <= F64_LEAF * scale, name
        # the f32 gradient is the f64 one of its own piece to f32 rounding
        t = own[name]
        dist[name] = float((g.double() - t).abs().max() / t.abs().max())
    assert len(dist) == len(grads) - 2 - 5
    assert np.median(list(dist.values())) <= F32_MEDIAN
    for name, d in dist.items():
        assert d <= F32_LEAF, (name, d)


def test_train_mode_moves_running_statistics_as_flax(step):
    model, tcfg = copy.deepcopy(step["model"]), step["tcfg"]
    train_step = tstep.make_train_step(model, tcfg)
    _, logs = train_step(create_train_state(tcfg, model), step["tb"])
    assert bool(torch.isfinite(logs["loss"]))
    bn = model.net.fpn.bn_stem
    for leaf, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        ref = np.asarray(step["new_bs"]["fpn"]["bn_stem"][leaf])
        assert np.abs(buf.numpy() - ref).max() <= 1e-5, leaf
