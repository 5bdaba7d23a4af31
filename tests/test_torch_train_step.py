"""Port parity of the slice: one train step and one eval step of the port
against the JAX package's, from the same weights (carried by
``utils/from_jax``) and the same synthetic batch, on the CPU. Tiny sizes:
ViT depth 2, C 128, 2 heads; ResNet-18; B = 2; ``img_res`` 160.

(a) HaMeR, f32, ``train=True`` on both sides (the model has neither
    BatchNorm nor dropout, so the whole step compares): every loss term 1e-5
    relative to max(|ref|, 1e-3); every gradient leaf within 1e-4 of the
    leaf's largest entry (observed 5e-5), but for the query path of the
    head's single-token cross-attention (``cross_attn.to_q`` and the
    ``norm1`` before it), whose gradient is a small difference of large
    terms: there f32 itself resolves no better than 4e-4 (the port in f32
    against the port in f64), and the bound is 2e-3 (observed 1.2e-3); the
    loss and the pre-clip gradient norm of each of five optimiser steps 1e-3
    relative.
(b) HaMeR, bf16: the port with ``fused_block=True`` (K4; on the CPU its
    forward is the twin) and f32 masters against the JAX model with
    ``fused_block=False`` (``block_math`` equals the Flax block, and the
    Pallas kernel cannot run un-interpreted here), the JAX side compiled with
    ``xla_allow_excess_precision=False``. bf16 bound: loss terms 2e-2 relative
    to max(|ref|, 1e-3). Each gradient leaf is held to the bf16 resolution of
    that leaf, measured as the distance between the JAX model's own bf16 and
    f32 gradients: the port's distance to the JAX bf16 gradient is at most
    twice that (observed 1.55 times for the largest entry, 1.19 times in the
    mean), and in absolute terms within 1e-1 of the leaf's largest entry
    (max; observed 7.1e-2) and 3e-2 (mean; observed 2.2e-2). The first layer
    of the grasp classifier is held in the mean only: one ReLU unit of 1024
    that flips under bf16 noise moves single entries of its gradient by a
    third of the largest (in the JAX model's own bf16 against f32 too). The
    block's own leaves are held tighter in
    test_torch_vit_block_trainable.py.
(c) WildHands ResNet-18, f32, mask and grasp loss on, dropout off on both
    sides (JAX: ``_forward_and_loss(..., train=False)`` under ``jax.grad``;
    port: the model in eval mode): loss terms 1e-5 relative to max(|ref|,
    1e-3) (observed 7e-7); every gradient leaf within 1e-4 of the leaf's
    largest entry (observed 3.5e-6).
(d) ResNet-18 ``train=True``: the output (1e-4 relative to max(|ref|, 1))
    and the new running mean and variance against Flax's ``batch_stats`` (1e-5
    absolute: momentum 0.99, biased variance).
(e) The port's loss falls over six steps at ``lr=1e-3`` in train mode
    (dropout and batch statistics on).
(f) ``make_eval_step``: metrics (NaN in the same places, 1e-4 relative to
    max(|ref|, 1)) and logs (1e-5).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train_util import both, rel_err
from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch as jax_make_batch
from hands_tpu.models.backbones.resnet import resnet18 as jax_resnet18
from hands_tpu.models.hamer_light import HamerLightModel as JaxHamer
from hands_tpu.models.hands_light import HandsLightModel as JaxHands
from hands_tpu.train import step as jstep
from hands_tpu.train.state import create_train_state as jax_create_state
from hands_tpu_torch.config import default_config
from hands_tpu_torch.data.synthetic import make_batch
from hands_tpu_torch.models.backbones.resnet import resnet18
from hands_tpu_torch.models.hamer_light import HamerLightModel
from hands_tpu_torch.models.hands_light import HandsLightModel
from hands_tpu_torch.models.heads.hmr import dropout
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.ops import mano_lbs, rasterizer, vit_block
from hands_tpu_torch.train import step as tstep
from hands_tpu_torch.train.state import create_train_state
from hands_tpu_torch.utils.from_jax import (_flatten, _resnet,
                                            state_dict_from_jax)
from test_torch_hands_light import fill_variables

NO_EXCESS = {"xla_allow_excess_precision": False}
RES = 160
SIZE = dict(img_res=RES, img_res_ds=RES)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _term_err(got, ref):
    a = float(ref)
    return abs(float(got) - a) / max(abs(a), 1e-3)


def _grad_errs(model, port_grads, jax_grads, batch_stats=None):
    """Per leaf: (max, mean) of |port - jax| over the leaf's largest |jax|
    entry, the JAX gradient tree laid out as the port's ``state_dict``."""
    tree = {"params": _np_tree(jax_grads)}
    if batch_stats is not None:
        tree["batch_stats"] = _np_tree(batch_stats)
    ref = state_dict_from_jax(tree, model)
    out = {}
    for name, g in port_grads.items():
        a = ref[name].float().numpy()
        b = g.float().numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), name
        scale = max(float(np.abs(a).max()), 1e-12)
        err = np.abs(a - b)
        out[name] = (float(err.max()) / scale, float(err.mean()) / scale)
    assert len(out) > 10
    return out


def _port_loss_and_grads(model, cfg, batch, train):
    model.train(train)
    total, loss_dict, _, _ = tstep.forward_and_loss(model, cfg, batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()))
    return loss_dict, dict(zip(named, grads))


# ------------------------------------------------------------------ HaMeR
def _hamer(dtype, fused_port, **kw):
    """Configs, the JAX model with perturbed weights, the port model carrying
    them as f32 masters, and one batch for each side."""
    ckw = dict(SIZE, compute_dtype=dtype, lr=1e-4, **kw)
    jcfg = jax_config("hamer_light", fused_block=False, **ckw)
    tcfg = default_config("hamer_light", fused_block=fused_port, **ckw)
    jb, tb = both(jax_make_batch(jcfg, 2, seed=0, np_arrays=True))
    jmodel = JaxHamer(jcfg, vit_variant="tiny")
    variables = jmodel.init(jax.random.PRNGKey(0), jb[0], jb[2])
    rng = np.random.RandomState(1)

    def perturb(path, p):
        leaf = jax.tree_util.keystr(path)
        p = np.asarray(p)
        if leaf.endswith("['scale']") or leaf.endswith("['bias']"):
            p = p + rng.randn(*p.shape).astype(np.float32) * 0.05
        return jnp.asarray(p)

    variables = {"params": jax.tree_util.tree_map_with_path(
        perturb, variables["params"])}
    model = HamerLightModel(tcfg, vit_variant="tiny",
                            param_dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(_np_tree(variables), model))
    return jcfg, tcfg, jmodel, variables, model, jb, tb


def _jax_loss_and_grads(jmodel, jcfg, variables, jb, train, options=None):
    def loss_fn(params):
        total, (loss_dict, _, _, _) = jstep._forward_and_loss(
            jmodel, jcfg, params, variables.get("batch_stats", {}), jb,
            jax.random.PRNGKey(1), train=train)
        return total, {k: v for k, (v, _) in loss_dict.items()}

    fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    return fn.lower(variables["params"]).compile(options)(variables["params"])


@functools.lru_cache(maxsize=1)
def _hamer_f32():
    """The f32 case and its JAX losses and gradients (compiled once: the
    bf16 test reads the same gradients as its resolution yardstick)."""
    case = _hamer("float32", False)
    jcfg, _, jmodel, variables, _, jb, _ = case
    return case, _jax_loss_and_grads(jmodel, jcfg, variables, jb, train=True)


def test_hamer_f32_train_step_matches_jax():
    (jcfg, tcfg, jmodel, variables, model, jb, tb), (gref, lref) = _hamer_f32()
    loss_dict, grads = _port_loss_and_grads(model, tcfg, tb, train=True)
    assert set(loss_dict) == set(lref) and len(lref) == 15
    for k, v in lref.items():
        assert _term_err(loss_dict[k][0].detach(), v) <= 1e-5, k
    errs = _grad_errs(model, grads, gref)
    for name, (worst, _) in errs.items():
        query_path = name.startswith("net.mano_head.layers.") and (
            ".cross_attn.to_q." in name or ".norm1." in name)
        assert worst <= (2e-3 if query_path else 1e-4), (name, worst)

    # five whole steps: loss and pre-clip gradient norm, step by step
    jstate = jax_create_state(jcfg, variables)
    jtrain = jstep.make_train_step(jmodel, jcfg, donate=False)
    state = create_train_state(tcfg, model)
    train = tstep.make_train_step(model, tcfg)
    first = None
    for i in range(5):
        jstate, jlogs = jtrain(jstate, jb, jax.random.PRNGKey(2 + i))
        state, logs = train(state, tb)
        assert set(logs) == set(jlogs)
        assert _term_err(logs["loss"], jlogs["loss"]) <= 1e-3, i
        assert _term_err(logs["grad_norm"], jlogs["grad_norm"]) <= 1e-3, i
        first = first if first is not None else float(logs["loss"])
    assert state.step == 5 == int(jstate.step)
    assert float(logs["loss"]) != first
    assert all(not v.requires_grad for v in logs.values())


def test_hamer_bf16_fused_train_step_matches_jax():
    jcfg, tcfg, jmodel, variables, model, jb, tb = _hamer("bfloat16", True)
    blk = model.net.backbone.blocks[0]
    assert blk.fused and blk.attn.qkv.weight.dtype == torch.float32
    gref, lref = _jax_loss_and_grads(jmodel, jcfg, variables, jb, train=True,
                                     options=NO_EXCESS)
    before = dict(vit_block.launches)
    loss_dict, grads = _port_loss_and_grads(model, tcfg, tb, train=True)
    assert vit_block.launches == before  # CPU: K4 ran its twin
    for k, v in lref.items():
        assert _term_err(loss_dict[k][0].detach(), v) <= 2e-2, k
    assert all(g.dtype == torch.float32 for g in grads.values())
    errs = _grad_errs(model, grads, gref)
    # the bf16 resolution of each leaf: JAX in bf16 against JAX in f32 (the
    # same seeded weights and batch)
    _, (gref32, _) = _hamer_f32()
    ref32 = state_dict_from_jax({"params": _np_tree(gref32)}, model)
    floor = _grad_errs(model, {k: ref32[k] for k in grads}, gref)
    for name, (worst, mean) in errs.items():
        assert mean <= min(3e-2, 2.0 * floor[name][1]), (name, mean)
        if not name.startswith("net.grasp_classifier.layers.0."):
            assert worst <= min(1e-1, 2.0 * floor[name][0]), (name, worst)


def test_hamer_train_mode_turns_int8_off():
    """``quant_int8`` (which implies ``fused_block``): eval serves the W8A8
    block, train mode runs K4 on the same f32 parameters, as the JAX model
    drops ``quant_int8`` under ``train=True``."""
    cfg8 = default_config("hamer_light", quant_int8=True, **SIZE)
    cfg = default_config("hamer_light", fused_block=True, **SIZE)
    m8 = fetch_model(cfg8, "cpu", seed=0, vit_variant="tiny")
    m = fetch_model(cfg, "cpu", seed=0, vit_variant="tiny",
                    param_dtype=torch.float32)
    batch = make_batch(cfg, 2, seed=0, device="cpu")
    m8.train(), m.train()
    a = m8(batch[0], batch[2])["mano.j3d.cam.r"]
    b = m(batch[0], batch[2])["mano.j3d.cam.r"]
    assert torch.equal(a, b)
    m8.eval()
    with torch.no_grad():
        assert not torch.equal(m8(batch[0], batch[2])["mano.j3d.cam.r"], a)


def test_vit_checkpoint_recomputes_plain_blocks_only():
    """``use_checkpoint`` (the JAX model's remat of a ViT-H without the fused
    block): same output and gradients as without it, in train mode only; a
    fused block keeps its own rematerialisation and is not wrapped."""
    from hands_tpu_torch.models.backbones.vit import ViTBackbone
    from hands_tpu_torch.models.registry import init_weights_

    x = torch.randn(2, 256, 192, 3, generator=torch.Generator().manual_seed(0))
    grads = {}
    for ckpt in (False, True):
        bb = ViTBackbone("tiny", use_checkpoint=ckpt)
        init_weights_(bb, torch.Generator().manual_seed(1))
        bb.train()
        out = bb(x)
        out.square().sum().backward()
        grads[ckpt] = (out.detach(), bb.blocks[0].attn.qkv.weight.grad)
    assert torch.equal(grads[True][0], grads[False][0])
    assert torch.equal(grads[True][1], grads[False][1])
    cfg = default_config("hamer_light", compute_dtype="float32", **SIZE)
    assert HamerLightModel(cfg, vit_variant="tiny").net.backbone \
        .use_checkpoint is False  # only ViT-H checkpoints, as in JAX
    fused = ViTBackbone("tiny", dtype=torch.bfloat16, fused_block=True,
                        use_checkpoint=True, param_dtype=torch.float32)
    init_weights_(fused, torch.Generator().manual_seed(1))
    fused.train()
    y = fused(x)
    assert "Checkpoint" not in y.grad_fn.next_functions[0][0].name()
    names, fn = set(), y.grad_fn
    while fn is not None and len(names) < 40:
        names.add(fn.name())
        fn = fn.next_functions[0][0] if fn.next_functions else None
    assert "_VitBlockTrainableBackward" in names


# -------------------------------------------------------------- WildHands
@pytest.fixture(scope="module")
def hands():
    ckw = dict(SIZE, backbone="resnet18", compute_dtype="float32")
    jcfg = jax_config("hands_light", **ckw)
    tcfg = default_config("hands_light", **ckw)
    assert tcfg.use_render_seg_loss and tcfg.use_grasp_loss
    jb, tb = both(jax_make_batch(jcfg, 2, seed=0, np_arrays=True))
    jmodel = JaxHands(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jb[0], jb[2]))
    variables = jax.tree.map(jnp.asarray, fill_variables(shapes, seed=1))
    model = HandsLightModel(tcfg)
    model.load_state_dict(state_dict_from_jax(_np_tree(variables), model))
    return jcfg, tcfg, jmodel, variables, model, jb, tb


def test_hands_light_loss_and_gradients_match_jax(hands):
    jcfg, tcfg, jmodel, variables, model, jb, tb = hands
    gref, lref = _jax_loss_and_grads(jmodel, jcfg, variables, jb, train=False)
    before = dict(mano_lbs.launches), dict(rasterizer.launches)
    loss_dict, grads = _port_loss_and_grads(model, tcfg, tb, train=False)
    assert before == (mano_lbs.launches, rasterizer.launches)
    assert set(loss_dict) == set(lref) and len(lref) == 15
    for k, v in lref.items():
        assert _term_err(loss_dict[k][0].detach(), v) <= 1e-5, k
    errs = _grad_errs(model, grads, gref, variables["batch_stats"])
    worst = max(errs, key=lambda k: errs[k][0])
    assert errs[worst][0] <= 1e-4, (worst, errs[worst])


def test_resnet18_train_mode_matches_flax():
    """Batch statistics in the forward, and Flax's running update: momentum
    0.99 and the biased batch variance."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    jnet = jax_resnet18()
    shapes = jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = fill_variables(shapes, seed=2)
    ref, new = jnet.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])

    # the ResNet rules of from_jax, on a tree with the backbone under "bb"
    def flat(params, stats):
        out = _flatten({"bb": _np_tree(params)})
        out.update(_flatten({"bb": _np_tree(stats)}, "batch_stats"))
        return out

    net = resnet18()
    rules = [(port[len("bb."):], path, fn)
             for port, path, fn in _resnet("bb", "bb", net)]
    jflat = flat(variables["params"], variables["batch_stats"])
    new_flat = flat(variables["params"], new["batch_stats"])
    sd = {port: torch.from_numpy(np.array(fn(jflat[path]) if fn
                                          else jflat[path]))
          for port, path, fn in rules}
    net.load_state_dict(sd)

    net.train()
    got = net(torch.from_numpy(x))
    assert rel_err(got.detach().numpy(), np.asarray(ref)) <= 1e-4
    checked = 0
    for port, path, _ in rules:
        if not path.startswith("batch_stats/"):
            continue
        b = net.state_dict()[port].numpy()
        np.testing.assert_allclose(b, new_flat[path], rtol=0, atol=1e-5,
                                   err_msg=port)
        assert np.abs(b - sd[port].numpy()).max() > 1e-4, port  # it moved
        checked += 1
    assert checked == 2 * 20  # mean and variance of every BatchNorm
    # eval mode reads the running statistics and leaves them alone
    net.eval()
    frozen = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    assert not torch.equal(out, got.detach())
    assert all(torch.equal(v, frozen[k]) for k, v in net.state_dict().items())


def test_resnet18_bf16_train_mode_keeps_f32_statistics():
    torch.manual_seed(0)
    net = resnet18(dtype=torch.bfloat16)
    for p in net.parameters():
        torch.nn.init.normal_(p, std=0.05)
    net.train()
    out = net(torch.randn(2, 64, 64, 3))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert net.bn_stem.running_mean.dtype == torch.float32
    assert float(net.bn_stem.running_mean.abs().max()) > 0
    out.float().sum().backward()
    assert net.conv_stem.weight.grad.dtype == torch.float32


def test_dropout_follows_its_generator():
    x = torch.ones(64, 256)
    a = dropout(x, 0.5, torch.Generator().manual_seed(3))
    b = dropout(x, 0.5, torch.Generator().manual_seed(3))
    c = dropout(x, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}  # kept entries doubled
    assert abs(float((a > 0).float().mean()) - 0.5) < 0.02
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None)


def test_hands_light_dropout_only_in_train_mode(hands):
    _, tcfg, _, _, model, _, tb = hands
    inputs, _, meta = tb
    model.eval()
    with torch.no_grad():
        e1 = model(inputs, meta)["mano.pose.r"]
        e2 = model(inputs, meta, generator=torch.Generator().manual_seed(1))
        assert torch.equal(e1, e2["mano.pose.r"])
        stats = {k: v.clone() for k, v in model.state_dict().items()}
        model.train()
        t1 = model(inputs, meta, generator=torch.Generator().manual_seed(1))
        model.load_state_dict(stats)
        t2 = model(inputs, meta, generator=torch.Generator().manual_seed(1))
        model.load_state_dict(stats)
        t3 = model(inputs, meta, generator=torch.Generator().manual_seed(2))
        model.load_state_dict(stats)
        with pytest.raises(ValueError, match="Generator"):
            model(inputs, meta)
    model.load_state_dict(stats)
    model.eval()
    assert torch.equal(t1["mano.pose.r"], t2["mano.pose.r"])
    assert not torch.equal(t1["mano.pose.r"], t3["mano.pose.r"])
    assert not torch.equal(t1["mano.pose.r"], e1)


def test_port_train_step_improves_loss():
    """As tests/test_e2e_train.py: six steps at lr 1e-3 on one batch, in
    train mode (dropout from a generator, batch statistics), f32."""
    cfg = default_config(
        "hands_light", backbone="resnet18", compute_dtype="float32",
        use_render_seg_loss=False, use_grasp_loss=False, use_glb_feat=False,
        lr=1e-3, **SIZE)
    model = fetch_model(cfg, "cpu", seed=0)
    batch = make_batch(cfg, 2, seed=0, device="cpu")
    state = create_train_state(cfg, model)
    step = tstep.make_train_step(model, cfg)
    gen = torch.Generator().manual_seed(1)
    mean0 = model.net.hand_backbone.bn_stem.running_mean.clone()
    state, logs0 = step(state, batch, gen)
    for _ in range(5):
        state, logs = step(state, batch, gen)
    assert np.isfinite(float(logs["loss"]))
    assert float(logs["loss"]) < float(logs0["loss"])
    assert float(logs["grad_norm"]) > 0
    assert state.step == 6 and model.training
    assert not torch.equal(model.net.hand_backbone.bn_stem.running_mean, mean0)


def test_eval_step_matches_jax(hands):
    jcfg, tcfg, jmodel, variables, model, jb, tb = hands
    jstate = jax_create_state(jcfg, variables)
    jmetrics, jlogs = jstep.make_eval_step(jmodel, jcfg)(jstate, jb)
    state = create_train_state(tcfg, model)
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    metrics, logs = tstep.make_eval_step(model, tcfg)(state, tb)
    assert not model.training  # the eval step puts the model in eval mode
    assert all(torch.equal(v, stats[k])
               for k, v in model.state_dict().items())
    assert set(metrics.keys()) == set(jmetrics.keys())  # jit sorts keys
    for k in jmetrics:
        a, b = np.asarray(jmetrics[k]), metrics[k].numpy()
        assert a.shape == b.shape, k
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        assert np.isfinite(b).any(), k
        assert rel_err(b[~np.isnan(b)], a[~np.isnan(a)]) <= 1e-4, k
    assert set(logs) == set(jlogs)
    for k in jlogs:
        assert _term_err(logs[k], jlogs[k]) <= 1e-5, k
    assert metrics["pix_err/h"].shape == (2, 42)
