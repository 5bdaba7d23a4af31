"""Two-rank data-parallel training of the port on the CPU (gloo), against the
JAX package's one-process step on the global batch, which is what the JAX
step sharded over a ``("data",)`` mesh computes under GSPMD.

Each run starts two ranks of ``python -m hands_tpu_torch.cli.parallel_check``
(they import torch only, pin one thread and rendezvous on a free localhost
port; every launch has its own 120 s limit, past which its ranks are killed
and the test fails); the JAX reference runs here. The global batch of four
images is one ``make_batch`` draw of the JAX package; each rank takes its two
rows. Tolerances are tests/test_torch_train_step.py's:

- tiny HaMeR (f32, ViT depth 2, C 128, 2 heads), DDP and FSDP: every loss
  term within 1e-5 of max(|ref|, 1e-3); every gradient leaf within 1e-4 of
  its largest entry, 2e-3 on the query path of the head's single-token
  cross-attention (a small difference of large terms, see there); the
  pre-clip ``grad_norm`` 1e-3; FSDP's ranks each hold a strict shard, and
  FSDP's gradient equals DDP's (1e-6 of each leaf's largest entry).
- ``acc_grad`` 2, tiny HaMeR, two micro-steps on one batch: the second
  micro-step's loss is the first's (nothing was updated in between), each
  micro-step's loss and ``grad_norm`` within 1e-3 of JAX's
  (``optax.MultiSteps``), and the first Adam moment after the second (0.1
  times the clipped mean gradient) at the gradient's bounds, DDP and FSDP.
- tiny WildHands (ResNet-18 at 160^2, the transformer decoder, which has no
  dropout; mask and grasp losses on) in train mode, where BatchNorm takes
  the global batch's moments over the ranks: every loss term 1e-5 of JAX's,
  ``grad_norm`` 1e-3, the new running statistics 1e-5 of JAX's
  ``batch_stats`` (absolute, as (d) there) and equal on the two ranks. Its
  f32 gradient is not held leaf by leaf: in train mode at this size a
  rounding moves ReLU zeros and max-pool ties, and the port's one-process
  f32 gradient is already 2.8e-2 of a leaf's largest entry from JAX's (the
  ranks' 1.5e-1). So the gradient through the ranks' BatchNorm (its
  moments' all-reduce and that all-reduce's backward) is held in f64
  (``utils/exact.py``), where no kink moves: DDP's and FSDP's gradients
  within 1e-9 of each leaf's largest entry of the port's one-process f64
  gradient.
- ``cli.train --num_processes 2 --device cpu --debug``: rank 0 alone writes
  the checkpoints (``last``, ``epoch_0000``, ``scores.json``) and the log, a
  resumed two-rank run starts from its epoch, and a one-process
  ``cli.demo --ckpt`` serves it exactly as ``load_serving_checkpoint`` +
  ``serve`` do, unlike random weights.
"""

import functools
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch as jax_make_batch
from hands_tpu.models.hamer_light import HamerLightModel as JaxHamer
from hands_tpu.models.hands_light import HandsLightModel as JaxHands
from hands_tpu.train import step as jstep
from hands_tpu.train.state import create_train_state as jax_create_state
from hands_tpu_torch.cli import demo as cli_demo
from hands_tpu_torch.cli import parallel_check as pc
from hands_tpu_torch.config import default_config
from hands_tpu_torch.models.hamer_light import HamerLightModel
from hands_tpu_torch.models.hands_light import HandsLightModel
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.parallel.launch import free_port, rank_env, run_ranks
from hands_tpu_torch.train.checkpoint import load_serving_checkpoint
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_hands_light import fill_variables

RANKS, TIMEOUT, B = 2, 120.0, 4
SIZE = dict(compute_dtype="float32", img_res=160, img_res_ds=160)
WH = dict(SIZE, backbone="resnet18", tf_decoder=True)


@pytest.fixture(autouse=True)
def free_files(tmp_path):
    """The ranks' tensors, weights and checkpoints take hundreds of MB a
    test: remove them as soon as the test is done."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads here (the ranks pin one each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _term_err(got, ref):
    return abs(float(got) - float(ref)) / max(abs(float(ref)), 1e-3)


def _leaf_errs(got, ref):
    """{leaf: (max, mean) of |got - ref| over the leaf's largest |ref|}."""
    out = {}
    for name, r in ref.items():
        r = r.double()
        d = (got[name].double() - r).abs()
        scale = max(float(r.abs().max()), 1e-12)
        out[name] = (float(d.max()) / scale, float(d.mean()) / scale)
    return out


def _case(method, batch_size=B, **kw):
    """The JAX model, its variables (every leaf drawn), the port model's
    state dict carrying them, and the global numpy batch."""
    if method == "hamer_light":
        jcfg = jax_config("hamer_light", fused_block=False, lr=1e-4,
                          **SIZE, **kw)
        jmodel = JaxHamer(jcfg, vit_variant="tiny")
        port = HamerLightModel(default_config("hamer_light", **SIZE, **kw),
                               vit_variant="tiny")
    else:
        jcfg = jax_config("hands_light", lr=1e-4, **WH, **kw)
        jmodel = JaxHands(jcfg)
        port = HandsLightModel(default_config("hands_light", **WH, **kw))
    batch = jax_make_batch(jcfg, batch_size, seed=0, np_arrays=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), batch[0], batch[2]))
    variables = fill_variables(shapes, seed=1)
    state_dict = state_dict_from_jax(_np(variables), port)
    return jcfg, jmodel, variables, port, state_dict, batch


def _jax_batch(batch):
    from hands_tpu.core.xdict import XDict

    return tuple(XDict({k: jnp.asarray(v) for k, v in d.items()})
                 for d in batch)


def _jax_grads(jcfg, jmodel, variables, batch):
    """The JAX one-process step's gradient on the global batch, its loss
    terms, new batch_stats and pre-clip gradient norm."""
    jb = _jax_batch(batch)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables.get("batch_stats", {}))

    def loss_fn(p):
        total, (loss_dict, _, _, new_bs) = jstep._forward_and_loss(
            jmodel, jcfg, p, stats, jb, jax.random.PRNGKey(1), train=True)
        return total, ({k: v for k, (v, _) in loss_dict.items()}, new_bs)

    grads, (terms, new_bs) = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    norm = float(np.sqrt(sum(float(jnp.sum(jnp.square(g)))
                             for g in jax.tree.leaves(grads))))
    return grads, terms, new_bs, norm


def _jax_steps(jcfg, jmodel, variables, batch, steps):
    """Each step's logs of the JAX train step, and its last state."""
    jb = _jax_batch(batch)
    state = jax_create_state(jcfg, jax.tree.map(jnp.asarray, variables))
    train = jstep.make_train_step(jmodel, jcfg, donate=False)
    logs = []
    for i in range(steps):
        state, step_logs = train(state, jb, jax.random.PRNGKey(2 + i))
        logs.append({k: float(v) for k, v in step_logs.items()})
    return logs, state


def _ranks(tmp_path, method, state_dict, batch, modes=("ddp", "fsdp"),
           steps=1, **overrides):
    """Two ranks of ``cli.parallel_check`` on the global batch; returns
    (rank summaries, rank 0's tensors by mode)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    weights = str(tmp_path / "weights.pt")
    torch.save(state_dict, weights)
    batch_path = str(tmp_path / "batch.npz")
    pc.save_batch(batch_path, batch)
    spec = {"method": method, "vit_variant": "tiny",
            "overrides": dict(overrides, num_workers=0,
                              batch_size=len(batch[2]["is_flipped"])),
            "weights": weights, "batch": batch_path, "steps": steps,
            "modes": list(modes), "save": str(tmp_path / "kept.pt"),
            "profile": False}
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    summaries = pc.launch(str(tmp_path / "spec.json"), str(tmp_path / "out"),
                          RANKS, ["--device", "cpu"], TIMEOUT, threads=1)
    return summaries, torch.load(spec["save"], weights_only=True)


def _held(jax_tree, stats, port):
    """A JAX gradient (or moment) tree laid out as the port's parameters."""
    tree = {"params": _np(jax_tree)}
    if stats:
        tree["batch_stats"] = _np(stats)
    ref = state_dict_from_jax(tree, port)
    return {n: ref[n] for n, _ in port.named_parameters()}


@functools.lru_cache(maxsize=None)
def _hamer(**kw):
    return _case("hamer_light", **kw)


def _hold_grads(got, ref, what):
    for name, (worst, _) in _leaf_errs(got, ref).items():
        query_path = name.startswith("net.mano_head.layers.") and (
            ".cross_attn.to_q." in name or ".norm1." in name)
        assert worst <= (2e-3 if query_path else 1e-4), (what, name, worst)


def test_two_ranks_hamer_ddp_and_fsdp_equal_the_jax_step(tmp_path):
    jcfg, jmodel, variables, port, sd, batch = _hamer()
    grads, terms, _, norm = _jax_grads(jcfg, jmodel, variables, batch)
    summaries, kept = _ranks(tmp_path, "hamer_light", sd, batch,
                             lr=1e-4, **SIZE)
    ref = _held(grads, None, port)
    for mode in ("ddp", "fsdp"):
        got = kept[mode]
        for k, v in terms.items():
            assert _term_err(got["logs"][0][k], v) <= 1e-5, (mode, k)
        assert _term_err(got["logs"][0]["grad_norm"], norm) <= 1e-3, mode
        _hold_grads(got["grads"], ref, mode)
    fsdp_vs_ddp = _leaf_errs(kept["fsdp"]["grads"], kept["ddp"]["grads"])
    assert max(w for w, _ in fsdp_vs_ddp.values()) <= 1e-6
    for s in summaries:
        f, d = s["modes"]["fsdp"], s["modes"]["ddp"]
        assert f["shard_bytes"] < f["total_bytes"] == d["shard_bytes"]
        assert d["logs"] == summaries[0]["modes"]["ddp"]["logs"]


def test_two_ranks_accumulate_gradients_as_jax(tmp_path):
    jcfg, jmodel, variables, port, sd, batch = _hamer(acc_grad=2)
    jlogs, jstate = _jax_steps(jcfg, jmodel, variables, batch, 2)
    _, kept = _ranks(tmp_path, "hamer_light", sd, batch, steps=2, lr=1e-4,
                     acc_grad=2, **SIZE)
    mu = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0].mu
    ref_mu = _held(mu, None, port)
    for mode in ("ddp", "fsdp"):
        got = kept[mode]
        assert got["logs"][1]["loss"] == got["logs"][0]["loss"], mode
        for i, want in enumerate(jlogs):
            for k in ("loss", "grad_norm"):
                assert _term_err(got["logs"][i][k], want[k]) <= 1e-3, \
                    (mode, i, k)
        _hold_grads(got["mu"], ref_mu, mode)


@functools.lru_cache(maxsize=None)
def _hands():
    return _case("hands_light")


def test_two_ranks_wildhands_batchnorm_takes_the_global_batch(tmp_path):
    from hands_tpu_torch.utils.exact import exact_grads
    from hands_tpu_torch.core.xdict import XDict

    jcfg, jmodel, variables, port, sd, batch = _hands()
    _, terms, new_bs, norm = _jax_grads(jcfg, jmodel, variables, batch)
    summaries, kept = _ranks(tmp_path, "hands_light", sd, batch,
                             modes=("ddp", "ddp_f64", "fsdp_f64"), lr=1e-4,
                             **WH)
    stats = state_dict_from_jax(
        {"params": _np(variables["params"]), "batch_stats": _np(new_bs)},
        port)
    got = kept["ddp"]
    for k, v in terms.items():
        assert _term_err(got["logs"][0][k], v) <= 1e-5, k
    assert _term_err(got["logs"][0]["grad_norm"], norm) <= 1e-3
    moved = [n for n in got["buffers"] if n.endswith("running_mean")
             or n.endswith("running_var")]
    assert len(moved) > 40
    for n in moved:
        np.testing.assert_allclose(got["buffers"][n].numpy(),
                                   stats[n].numpy(), rtol=0, atol=1e-5,
                                   err_msg=n)
    assert all(s["modes"]["ddp"]["bn_spread"] == 0.0 for s in summaries)

    # the gradient through the ranks' BatchNorm, in f64
    port.load_state_dict(sd)
    port.train()  # exact_grads runs the model in the mode it is in
    port_batch = tuple(XDict({k: torch.from_numpy(np.array(v))
                              for k, v in d.items()}) for d in batch)
    _, _, exact = exact_grads(port, port.cfg, port_batch)
    ref = {n: g for (n, _), g in zip(port.named_parameters(), exact)}
    for mode in ("ddp_f64", "fsdp_f64"):
        errs = _leaf_errs(kept[mode]["grads"], ref)
        worst = max(errs, key=lambda n: errs[n][0])
        assert errs[worst][0] <= 1e-9, (mode, worst, errs[worst])


def _train_ranks(tmp_path, extra, over):
    """Two ranks of ``cli.train`` (each its own process, one thread)."""
    address = f"localhost:{free_port()}"
    code = ("import json, sys; from hands_tpu_torch.cli import train; "
            "train.main(sys.argv[3:], log_root=sys.argv[1], "
            "overrides=json.loads(sys.argv[2]))")
    cmds = [[sys.executable, "-c", code, str(tmp_path / "logs"),
             json.dumps(over), "--debug", "--device", "cpu", "--no_vis",
             "--eval_every_epoch", "1", "--num_processes", str(RANKS),
             "--process_id", str(r), "--coordinator_address", address]
            + extra for r in range(RANKS)]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(pc.__file__))))
    return run_ranks(cmds, TIMEOUT, env=rank_env(1), cwd=repo)


def test_cli_train_two_ranks_write_one_checkpoint_resume_and_serve(tmp_path):
    over = dict(WH, tf_decoder=False, use_glb_feat=False, logger="none",
                batch_size=2, test_batch_size=2, exp_key="dp",
                trainsplit="tinytrain", valsplit="tinyval")
    outs = _train_ranks(tmp_path, [], over)
    for r, out in enumerate(outs):
        assert f"multi-process: process {r}/2, backend gloo, device cpu" \
            in out
    ck = tmp_path / "logs" / "dp" / "checkpoints"
    assert sorted(os.listdir(ck)) == ["epoch_0000", "last", "scores.json"]
    assert sorted(os.listdir(tmp_path / "logs")) == ["dp"]
    rows = [json.loads(ln) for ln in open(tmp_path / "logs" / "dp" /
                                          "metrics.jsonl")]
    assert any("loss__val" in r for r in rows)  # rank 0's log only
    outs = _train_ranks(tmp_path, ["--resume_ckpt", str(ck / "last")],
                        dict(over, exp_key=""))
    assert all("resumed from epoch 1" in out for out in outs)

    # one process serves it: the demo against load_serving_checkpoint
    photos = tmp_path / "photos"
    photos.mkdir()
    from PIL import Image

    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (120, 160, 3), np.uint8)).save(
            photos / f"p{i}.png")
    serve_over = {k: over[k] for k in ("backbone", "img_res", "img_res_ds",
                                       "use_glb_feat")}
    assert cli_demo.main(["--dir", str(photos), "--device", "cpu",
                          "--no_vis", "--batch_size", "2", "--out",
                          str(tmp_path / "demo"), "--ckpt",
                          str(ck / "last")], serve_over) == 0
    scfg = cli_demo.serving_config("hands_light", "float32").replace(
        **serve_over)
    model = fetch_model(scfg, device="cpu", seed=0)
    recs = [cli_demo.make_record(str(photos / f"p{i}.png"),
                                 np.asarray(Image.open(photos / f"p{i}.png")))
            for i in range(2)]
    fresh = cli_demo.serve(recs, scfg, model, "cpu").to_np()
    load_serving_checkpoint(model, str(ck / "last"))
    want = cli_demo.serve(recs, scfg, model, "cpu").to_np()
    for i in range(2):
        got = np.load(tmp_path / "demo" / f"p{i}_pred.npz")
        for k in got.files:
            np.testing.assert_array_equal(got[k], want[k][i], err_msg=k)
        assert not np.array_equal(got["pred.mano.pose.r"],
                                  fresh["pred.mano.pose.r"][i])
