"""Megatron tensor parallelism of the port (``parallel/sharding.py``) on four
CPU ranks of one gloo group, against the JAX package
(tests/test_sharding_tp.py's cases).

One module fixture starts four ranks of this file (``parallel/launch.py:
run_ranks``, one thread each, a free localhost port, a 120 s limit); each
rank runs every case below and writes its tensors, and the JAX side runs
here on the same numpy weights and inputs:

- ``vit_tp_spec`` equals the JAX rule on every leaf name of the tiny ViT and
  the tiny HaMeR;
- the tiny f32 ViT on 2 and on 4 model ranks (the ``"model"`` lines of a
  (2, 2) and a (1, 4) ``("data", "model")`` mesh) against JAX's replicated
  ``apply`` and its TP ``apply`` on a (2, 4) mesh: 2e-5. The tiny ViT has 2
  heads, which 4 ranks cannot share by heads (the port's qkv layout; GSPMD
  splits the 3C columns anywhere), so the 4-rank case runs the tiny width
  with 4 heads of 32 (``TINY4``, added to both packages' variant tables for
  the test);
- the loss ``sum(out^2) / size`` and its gradients on 2 ranks, gathered
  (``full_tp``), against ``jax.value_and_grad``: 1e-6, and atol 1e-5 /
  rtol 1e-4;
- each shard holds 1/4 of its features on 4 ranks, and the qkv shard holds
  exactly rows {q, k, v} x its head of the JAX kernel (``TINY4``);
- the tiny bf16 ``fused_block`` HaMeR (K3's twins) under TP on 2 ranks
  against the one-rank port and the JAX XLA block: 2e-2 of max(|ref|, 1),
  tests/test_torch_hamer.py's bf16 bound;
- ``vit_block_backward`` with the ``reduce`` hook (K4 through its
  ``autograd.Function``, the twins on the CPU) on 2 ranks against the
  one-rank block: 1e-3 of each leaf's largest entry (``K4_GRAD_REL``);
- a ``("data", "model")`` mesh of (2, 2) through ``Trainer``: each rank
  loads the rows of its data coordinate, the ranks of one data coordinate
  hold equal replicas after two steps, and the steps equal the one-process
  steps on the global batch (loss and ``grad_norm``, 1e-5 / 1e-4).
"""

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

RANKS, TIMEOUT = 4, 120.0
IMG = (64, 48)
TINY4 = dict(embed_dim=128, depth=2, num_heads=4, mlp_ratio=2.0)
HAMER_REL = 2e-2  # tests/test_torch_hamer.py's bf16 bound
K4_GRAD_REL = 1e-3
TRAIN = dict(compute_dtype="float32", img_res=96, img_res_ds=64,
             use_render_seg_loss=False, lr=1e-6, batch_size=4,
             num_workers=0)
STEPS = 2


# ------------------------------------------------------------- the ranks
def _load_vit(bb, flat):
    """JAX ``ViTBackbone`` params (flat "a/b/c" numpy leaves) into the port
    backbone, by the weight converter's rules."""
    from hands_tpu_torch.utils import from_jax

    sd = {}
    for port, jax_path, fn, index in from_jax._vit("", "", bb):
        a = flat[jax_path[1:]]
        a = a if index is None else a[index]
        sd[port[1:]] = torch.from_numpy(np.array(fn(a) if fn else a,
                                                 np.float32))
    bb.load_state_dict(sd)


def _nest(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *head, last = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _tp_vit(mesh, flat, variant="tiny"):
    from hands_tpu_torch.models.backbones.vit import ViTBackbone
    from hands_tpu_torch.parallel.sharding import shard_vit_tp

    bb = ViTBackbone(variant, dtype=torch.float32, img_hw=IMG)
    _load_vit(bb, flat)
    return shard_vit_tp(bb, mesh.axis("model"))


def _params(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}


def _case_forward(meshes, data, out):
    x = torch.from_numpy(data["x"])
    for n, mesh in meshes.items():
        variant = "tiny" if n == 2 else "tiny4"
        bb = _tp_vit(mesh, _params(data, f"{variant}/"), variant)
        with torch.no_grad():
            out[f"fwd{n}"] = bb(x).numpy()
        if n == 4:
            from hands_tpu_torch.parallel.sharding import tp_shard_shapes

            out["qkv_local"] = bb.blocks[0].attn.qkv.weight.detach().numpy()
            out["qkv_bias_local"] = bb.blocks[0].attn.qkv.bias.detach().numpy()
            out["shapes"] = np.array(json.dumps(tp_shard_shapes(bb)))


def _case_grads(meshes, data, out):
    from hands_tpu_torch.parallel.sharding import full_tp

    bb = _tp_vit(meshes[2], _params(data, "tiny/"))
    y = bb(torch.from_numpy(data["x_grad"]))
    loss = torch.sum(y ** 2) / y.numel()
    loss.backward()
    out["loss"] = loss.detach().numpy()
    for name, p in bb.named_parameters():
        out[f"grad/{name}"] = full_tp(p.grad, p).numpy()


def _case_hamer(meshes, data, out):
    from hands_tpu_torch.cli.demo import serving_config
    from hands_tpu_torch.models.hamer_light import HamerLightModel
    from hands_tpu_torch.parallel.sharding import shard_vit_tp
    from hands_tpu_torch.utils.from_jax import state_dict_from_jax

    variables = {"params": _nest({k[6:]: data[k] for k in data.files
                                  if k.startswith("hamer/")})}
    model = HamerLightModel(serving_config("hamer_light", "bfloat16", True),
                            vit_variant="tiny")
    model.load_state_dict(state_dict_from_jax(variables, model))
    tin = {k[7:]: torch.from_numpy(data[k]) for k in data.files
           if k.startswith("inputs/")}
    meta = {"intrinsics": torch.from_numpy(data["intrinsics"])}
    with torch.no_grad():
        one = model(tin, meta)
        shard_vit_tp(model, meshes[2].axis("model"))
        tp = model(tin, meta)
    for k in one:
        out[f"hamer_one/{k}"] = one[k].float().numpy()
        out[f"hamer_tp/{k}"] = tp[k].float().numpy()


def _case_block_backward(meshes, data, out):
    from hands_tpu_torch.models.backbones.vit import ViTBackbone
    from hands_tpu_torch.models.registry import init_weights_
    from hands_tpu_torch.parallel.sharding import full_tp, shard_vit_tp

    bb = ViTBackbone("tiny", dtype=torch.bfloat16, fused_block=True,
                     param_dtype=torch.float32, img_hw=IMG)
    init_weights_(bb, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():  # every bias and LayerNorm off its init
        for p in bb.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.randn((2, 12, 128), generator=gen).to(torch.bfloat16)
    g = torch.randn((2, 12, 128), generator=gen).to(torch.bfloat16)

    def grads(block):
        xg = x.clone().requires_grad_(True)
        params = list(block.parameters())
        got = torch.autograd.grad(block(xg), [xg] + params, g)
        return [got[0]] + [full_tp(t, p) for t, p in zip(got[1:], params)]

    names = ["x"] + [n for n, _ in bb.blocks[0].named_parameters()]
    one = grads(bb.blocks[0])
    shard_vit_tp(bb, meshes[2].axis("model"))
    tp = grads(bb.blocks[0])
    for n, a, b in zip(names, one, tp):
        out[f"bwd_one/{n}"] = a.float().numpy()
        out[f"bwd_tp/{n}"] = b.float().numpy()


def _case_trainer(meshes, data, out):
    import torch.distributed as dist

    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.core.xdict import device_view
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.data.device_pipeline import DeviceDataLoader
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.trainer import Trainer
    from hands_tpu_torch.utils.experiment import Experiment

    cfg = default_config("hamer_light", mesh_shape=(2, 2),
                         mesh_axis_names=("data", "model"), logger="none",
                         mute=True, **TRAIN)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, fetch_model(cfg, "cpu", seed=0,
                                           vit_variant="tiny"),
                          Experiment(cfg, root=tmp))
        shard = trainer.data_shard
        loader = DeviceDataLoader(SyntheticRecordDataset(cfg, "train", 8),
                                  cfg, cfg.batch_size, is_train=False,
                                  shard=shard, device="cpu", num_workers=0)
        state, _ = trainer.init_state()
        logs = []
        for i, (inputs, targets, meta) in enumerate(loader):
            if i == STEPS:
                break
            out[f"imgname{i}"] = np.array(meta["imgname"])
            state, step_logs = trainer.train_step(
                state, (inputs, targets, device_view(meta)))
            logs.append({k: float(v) for k, v in step_logs.items()})
        dist.barrier()
    flat = torch.cat([p.detach().reshape(-1) for p in state.params])
    every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(every, flat)
    out["replicas_equal"] = np.array([torch.equal(every[0], e)
                                      for e in every])
    out["shard"] = np.array(shard)
    out["dp_world"] = np.array(0 if trainer.dp is None else trainer.dp.world)
    out["logs"] = np.array(json.dumps(logs))


def _rank_main(argv) -> int:
    import datetime

    import torch.distributed as dist

    from hands_tpu_torch.parallel.mesh import make_mesh

    from hands_tpu_torch.models.backbones import vit

    rank, port, data_dir = int(argv[0]), argv[1], argv[2]
    torch.set_num_threads(1)
    vit.VIT_CONFIGS["tiny4"] = TINY4
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=RANKS,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    meshes = {2: make_mesh((2, 2), ("data", "model"), "cpu"),
              4: make_mesh((1, 4), ("data", "model"), "cpu")}
    data = np.load(os.path.join(data_dir, "inputs.npz"))
    out = {}
    for case in (_case_forward, _case_grads, _case_hamer,
                 _case_block_backward, _case_trainer):
        case(meshes, data, out)
    np.savez(os.path.join(data_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(_rank_main(sys.argv[1:]))


# -------------------------------------------------------------- JAX side
@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads here (the ranks pin one each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.array(v, np.float32)
    return out


@pytest.fixture(scope="module")
def jax_side(devices):
    """The JAX tiny ViTs' params and their replicated and TP outputs, the
    loss and gradients; the tiny HaMeR's inputs (numpy draws in the
    preprocessor's layout), weights (every LayerNorm and bias off its init,
    as tests/test_torch_hamer.py perturbs them) and bf16 XLA output (one
    program without excess precision, so its bf16 roundings stay)."""
    from unittest import mock

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hands_tpu.models.backbones import vit as jax_vit
    from hands_tpu.models.hamer_light import HamerLightModel as JaxHamer
    from hands_tpu.parallel.mesh import make_mesh
    from hands_tpu.parallel.sharding import vit_tp_shardings
    from hands_tpu_torch.cli.demo import serving_config

    out = {}
    x = np.random.RandomState(0).rand(4, *IMG, 3).astype(np.float32)
    mesh = make_mesh((2, 4), ("data", "model"), devices=devices)
    with mock.patch.dict(jax_vit.VIT_CONFIGS, {"tiny4": TINY4}):
        for variant in ("tiny", "tiny4"):
            vit = jax_vit.ViTBackbone(variant=variant, dtype=jnp.float32)
            params = jax.jit(vit.init)(jax.random.PRNGKey(0), x)["params"]
            fwd = jax.jit(lambda p, v, m=vit: m.apply({"params": p}, v))
            with mesh:
                ref_tp = fwd(jax.device_put(params,
                                            vit_tp_shardings(params, mesh)),
                             jax.device_put(x, NamedSharding(mesh,
                                                             P("data"))))
            out[variant] = dict(params=_flat(params), ref=np.asarray(
                vit.apply({"params": params}, x)), ref_tp=np.asarray(ref_tp))
    vit = jax_vit.ViTBackbone(variant="tiny", dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, _nest(out["tiny"]["params"]))
    x_grad = np.random.RandomState(1).rand(2, *IMG, 3).astype(np.float32)

    def loss_fn(p, v):
        y = vit.apply({"params": p}, v)
        return jnp.sum(y ** 2) / y.size

    loss, grads = jax.value_and_grad(loss_fn)(params, x_grad)

    rng = np.random.RandomState(2)
    inputs = {k: rng.randn(2, 224, 224, 3).astype(np.float32)
              for k in ("img", "r_img", "l_img")}
    for side in "rl":
        box = np.array([[10.0, 20.0, 150.0, 170.0], [30.0, 5.0, 200.0, 190.0]],
                       np.float32)
        inputs.update({f"{side}_bbox": box, f"{side}_bbox_og": box + 1.0,
                       f"{side}_center_angle": 0.1 * rng.randn(2, 2),
                       f"{side}_corner_angle": 0.1 * rng.randn(2, 8)})
    inputs = {k: np.asarray(v, np.float32) for k, v in inputs.items()}
    meta = {"intrinsics": np.tile(np.array(
        [[900.0, 0, 112.0], [0, 900.0, 112.0], [0, 0, 1]], np.float32),
        (2, 1, 1))}
    cfg = serving_config("hamer_light", "bfloat16", False)
    model = JaxHamer(cfg, vit_variant="tiny")
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), inputs, meta)

    def perturb(path, p):  # every LayerNorm scale and bias off its init
        p = np.asarray(p)
        leaf = jax.tree_util.keystr(path)
        if leaf.endswith("['scale']") or leaf.endswith("['bias']"):
            p = p + rng.randn(*p.shape).astype(np.float32) * 0.05
        return p

    variables = {"params": jax.tree_util.tree_map_with_path(
        perturb, variables["params"])}
    hamer_ref = jax.jit(lambda v, i, m: dict(model(v, i, m))).lower(
        variables, inputs, meta).compile(
            {"xla_allow_excess_precision": False})(variables, inputs, meta)
    out.update(x=x, x_grad=x_grad, loss=float(loss), grads=_flat(grads),
               hamer=_flat(variables["params"]),
               inputs={k: np.array(v, np.float32) for k, v in inputs.items()},
               intrinsics=np.array(meta["intrinsics"], np.float32),
               hamer_ref={k: np.array(v, np.float32)
                          for k, v in hamer_ref.items()})
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Every rank's tensors (the four ranks run once for the module)."""
    from hands_tpu_torch.parallel.launch import free_port, rank_env, run_ranks

    tmp = tempfile.mkdtemp()
    try:
        j = jax_side
        arrays = {"x": j["x"], "x_grad": j["x_grad"],
                  "intrinsics": j["intrinsics"]}
        for variant in ("tiny", "tiny4"):
            arrays.update({f"{variant}/{k}": v
                           for k, v in j[variant]["params"].items()})
        arrays.update({f"hamer/{k}": v for k, v in j["hamer"].items()})
        arrays.update({f"inputs/{k}": v for k, v in j["inputs"].items()})
        np.savez(os.path.join(tmp, "inputs.npz"), **arrays)
        port = str(free_port())
        run_ranks([[sys.executable, os.path.abspath(__file__), str(r), port,
                    tmp] for r in range(RANKS)], TIMEOUT, env=rank_env(1))
        out = []
        for r in range(RANKS):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as f:
                out.append({k: f[k] for k in f.files})
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _leaf_names(model):
    import jax

    return [(jax.tree_util.keystr(p, simple=True, separator="/"), v.ndim)
            for p, v in jax.tree_util.tree_leaves_with_path(model)]


@pytest.mark.parametrize("family", ["vit", "hamer"])
def test_vit_tp_spec_equals_jax(jax_side, family):
    from hands_tpu.parallel.sharding import vit_tp_spec as jax_spec
    from hands_tpu_torch.parallel.sharding import vit_tp_spec

    leaves = (jax_side["tiny"]["params"] if family == "vit"
              else jax_side["hamer"])
    assert len(leaves) > 10
    split = 0
    for name, a in leaves.items():
        want = jax_spec(name, a.ndim)
        assert vit_tp_spec(name, a.ndim) == want, name
        split += "model" in want
    assert split >= 4


@pytest.mark.parametrize("n", [2, 4])
def test_tp_forward_matches_jax(jax_side, ranks, n):
    ref = jax_side["tiny" if n == 2 else "tiny4"]
    for r in ranks:  # every model rank returns the whole output
        np.testing.assert_allclose(r[f"fwd{n}"], ref["ref"], atol=2e-5)
        np.testing.assert_allclose(r[f"fwd{n}"], ref["ref_tp"], atol=2e-5)


def test_tp_loss_and_grads_match_jax(jax_side, ranks):
    from hands_tpu_torch.models.backbones.vit import ViTBackbone
    from hands_tpu_torch.parallel.sharding import jax_leaf_names

    names = jax_leaf_names(ViTBackbone("tiny", img_hw=IMG))
    r = ranks[0]
    np.testing.assert_allclose(float(r["loss"]), jax_side["loss"], rtol=1e-6)
    for port, jax_path in names.items():
        got = r[f"grad/{port}"]
        ref = jax_side["grads"][jax_path]
        ref = ref[int(port.split(".")[1])] if port.startswith("blocks.") \
            else ref
        if got.ndim == 2 and ref.ndim == 2:
            ref = ref.T  # Dense kernels (in, out) -> (out, in)
        elif got.ndim == 4:
            ref = ref.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(got, ref.reshape(got.shape), atol=1e-5,
                                   rtol=1e-4, err_msg=port)


def test_tp_shard_shapes_and_qkv_heads(jax_side, ranks):
    shapes = json.loads(str(ranks[0]["shapes"]))
    assert len(shapes) == 2 * 6  # 2 blocks, 6 split leaves each
    for name, (local, full) in shapes.items():
        split = [i for i, (a, b) in enumerate(zip(local, full)) if a != b]
        assert len(split) == 1 and local[split[0]] * 4 == full[split[0]], name
    params = jax_side["tiny4"]["params"]
    kernel = params["blocks/block/attn/qkv/kernel"][0].T  # (3C, C)
    bias = params["blocks/block/attn/qkv/bias"][0]
    C = kernel.shape[1]
    D = C // TINY4["num_heads"]  # one head a rank
    for r, out in enumerate(ranks):
        rows = np.concatenate([np.arange(s * C + r * D, s * C + (r + 1) * D)
                               for s in range(3)])
        np.testing.assert_array_equal(out["qkv_local"], kernel[rows])
        np.testing.assert_array_equal(out["qkv_bias_local"], bias[rows])


def test_tp_bf16_fused_hamer_matches_one_rank_and_jax(jax_side, ranks):
    ref = jax_side["hamer_ref"]
    for r in ranks:
        for k, want in ref.items():
            one, tp = r[f"hamer_one/{k}"], r[f"hamer_tp/{k}"]
            scale = np.maximum(np.abs(want), 1.0)
            assert np.max(np.abs(tp - one) / np.maximum(np.abs(one), 1.0)) \
                <= HAMER_REL, k
            assert np.max(np.abs(tp - want) / scale) <= HAMER_REL, k


def test_tp_block_backward_matches_one_rank(ranks):
    for r in ranks:
        names = [k[len("bwd_one/"):] for k in r if k.startswith("bwd_one/")]
        assert len(names) == 13
        for n in names:
            one, tp = r[f"bwd_one/{n}"], r[f"bwd_tp/{n}"]
            scale = max(float(np.abs(one).max()), 1e-12)
            assert float(np.abs(tp - one).max()) <= K4_GRAD_REL * scale, n


def test_data_model_mesh_trains_as_jax_trainer(ranks):
    """``("data", "model")`` of (2, 2): rows by data coordinate, equal
    replicas, the one-process steps on the global batch."""
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.core.xdict import device_view
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.data.device_pipeline import DeviceDataLoader
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_train_step

    cfg = default_config("hamer_light", **TRAIN)
    loader = DeviceDataLoader(SyntheticRecordDataset(cfg, "train", 8), cfg,
                              cfg.batch_size, is_train=False, device="cpu",
                              num_workers=0)
    model = fetch_model(cfg, "cpu", seed=0, vit_variant="tiny")
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    ref, names = [], []
    for i, (inputs, targets, meta) in enumerate(loader):
        if i == STEPS:
            break
        names.append(list(meta["imgname"]))
        state, logs = step(state, (inputs, targets, device_view(meta)))
        ref.append({k: float(v) for k, v in logs.items()})
    half = cfg.batch_size // 2
    for rank, r in enumerate(ranks):
        d = rank // 2  # the data coordinate of rank (d, m) of a (2, 2) mesh
        assert tuple(r["shard"]) == (d, 2)
        assert int(r["dp_world"]) == 2
        assert r["replicas_equal"].all()
        for i in range(STEPS):
            assert list(r[f"imgname{i}"]) == names[i][d * half:(d + 1) * half]
        for got, want in zip(json.loads(str(r["logs"])), ref):
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
            assert abs(got["grad_norm"] - want["grad_norm"]) <= \
                1e-4 * abs(want["grad_norm"])
