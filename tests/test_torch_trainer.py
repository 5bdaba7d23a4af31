"""The port's ``Trainer`` (``hands_tpu_torch.train.trainer``) and its entry
points: the port's versions of the tests of tests/test_trainer.py, a parity
run against the JAX ``Trainer``, and a ``--debug`` epoch through
``cli.train``.

Parity: both trainers fit the same tiny WildHands (ResNet-18 at 160^2, the
transformer decoder, which has no dropout, so ``train=True`` compares whole)
from the same weights (``utils/from_jax``) for one epoch of four steps on the
same eval-mode loader of the same synthetic records, then validate on three
records in batches of two (a padded tail). ``loss__train`` window means,
``loss__val`` and every ``metric.*__val`` agree to 1e-3 relative to
max(|ref|, 1e-3) at lr 1e-7. The single steps agree to 1e-5
(tests/test_torch_train_step.py); Adam's first updates move every weight by
+-lr whatever its gradient's size, so an entry whose near-zero gradient has
another sign in the two frameworks parts the two runs: at the default lr 1e-5
(gradient norm 5e3 to 1e4 from these random weights) the logged values drift
apart by 1.2e-3 after two steps and 1.7e-2 at validation, at 1e-7 a hundred
times less, while BatchNorm's running statistics, the window means, the
padded tail and the ``nanmean`` still do all their work. The pre-clip
gradient norm, which the loops also log, is held to 5e-3.
"""

import dataclasses
import glob
import json
import os
import re
import shutil
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.datasets import SyntheticRecordDataset as JaxSynthetic
from hands_tpu.data.device_pipeline import DeviceDataLoader as JaxLoader
from hands_tpu.models.registry import fetch_model as jax_fetch_model
from hands_tpu.train import trainer as jtrainer
from hands_tpu.utils.experiment import Experiment as JaxExperiment
from hands_tpu_torch.cli import evaluate as cli_evaluate
from hands_tpu_torch.cli.convert_ckpt import main as convert_main
from hands_tpu_torch.cli import train as cli_train
from hands_tpu_torch.config import default_config
from hands_tpu_torch.data.datasets import SyntheticRecordDataset
from hands_tpu_torch.data.device_pipeline import DeviceDataLoader
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.train.checkpoint import CheckpointManager
from hands_tpu_torch.train.trainer import Trainer
from hands_tpu_torch.utils.experiment import Experiment
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_ckpt_import import resnet_reference_sd
from test_torch_hands_light import fill_variables

TINY = dict(backbone="resnet18", compute_dtype="float32", use_glb_feat=False,
            use_render_seg_loss=False, use_grasp_loss=False, batch_size=2,
            test_batch_size=2, eval_every_epoch=1, log_every=2,
            val_dataset="synthetic", dataset="synthetic", img_res=160,
            img_res_ds=160, logger="none", no_vis=True)


@pytest.fixture(autouse=True)
def free_checkpoints(tmp_path):
    """A checkpoint of even this tiny model (weights and two Adam moments)
    takes 270 MB: remove each test's files as soon as it is done."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs six workers side by side, and
    eight threads each stall one another at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**kw):
    return default_config("hands_light", **dict(TINY, **kw))


def _loaders(cfg, n_train=4, n_val=2):
    train = DeviceDataLoader(SyntheticRecordDataset(cfg, "train", n_train),
                             cfg, 2, is_train=True, device="cpu",
                             num_workers=0)
    val = DeviceDataLoader(SyntheticRecordDataset(cfg, "val", n_val), cfg, 2,
                           is_train=False, drop_last=False, device="cpu",
                           num_workers=0)
    return train, val


def _rows(exp_dir):
    return [json.loads(ln) for ln in
            open(os.path.join(exp_dir, "metrics.jsonl"))]


def test_fit_one_epoch_checkpoints_and_logs(tmp_path):
    cfg = tiny_cfg()
    train_loader, val_loader = _loaders(cfg)
    model = fetch_model(cfg, "cpu")
    exp = Experiment(cfg, root=str(tmp_path / "logs"))
    trainer = Trainer(cfg, model, exp)
    bn = model.net.hand_backbone.bn_stem
    state = trainer.fit(train_loader, val_loader, num_epochs=1)
    assert state.step == 2 and state.tx.count == 2  # 4 samples / bs 2
    assert trainer.ckpt.has_checkpoint("last")
    scores = json.load(open(os.path.join(trainer.ckpt.ckpt_dir,
                                         "scores.json")))
    assert list(scores) == ["epoch_0000"]
    assert trainer.ckpt.has_checkpoint("epoch_0000")
    rows = _rows(exp.dir)
    train_rows = [r for r in rows if "loss__train" in r]
    val_rows = [r for r in rows if "loss__val" in r]
    assert len(train_rows) == 1 and train_rows[0]["step"] == 2
    assert len(val_rows) == 1 and scores["epoch_0000"] == val_rows[0][
        "loss__val"]
    assert any(k.startswith("metric.") and k.endswith("__val")
               for k in val_rows[0])
    assert any("epoch_time_s" in r for r in rows)
    assert os.path.exists(os.path.join(exp.dir, "args.json"))
    assert trainer.timing["steps"] == 2 and trainer.timing["loop_s"] > 0
    assert 0 <= trainer.timing["data_s"] <= trainer.timing["loop_s"]
    # validation ran in eval mode and left the running statistics alone
    assert not model.training
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    model.train()  # validate must switch the mode itself
    out = trainer.validate(state, val_loader)
    assert not model.training
    assert torch.equal(bn.running_mean, stats[0])
    assert torch.equal(bn.running_var, stats[1])
    assert np.isfinite(out["loss"]) and out["loss"] == val_rows[0]["loss__val"]


def test_checkpoint_roundtrip(tmp_path):
    cfg = tiny_cfg()
    model = fetch_model(cfg, "cpu")
    from hands_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, model)
    ckpt = CheckpointManager(str(tmp_path / "ckpts"))
    ckpt.save_last(state, epoch=3)
    p0 = state.params[0].clone()
    with torch.no_grad():
        for p in state.params:
            p.zero_()
    restored, epoch = ckpt.restore(state, "last")
    assert epoch == 3
    torch.testing.assert_close(restored.params[0], p0, rtol=0, atol=0)


def test_checkpoint_topk_eviction(tmp_path):
    cfg = tiny_cfg()
    model = fetch_model(cfg, "cpu")
    from hands_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, model)
    ckpt = CheckpointManager(str(tmp_path / "ck"), top_k=2)
    for epoch, score in [(0, 5.0), (1, 3.0), (2, 4.0), (3, 1.0)]:
        ckpt.save_top_k(state, epoch, score)
    scores = json.load(open(str(tmp_path / "ck" / "scores.json")))
    assert set(scores) == {"epoch_0003", "epoch_0001"}
    assert os.path.exists(str(tmp_path / "ck" / "epoch_0003"))
    assert not os.path.exists(str(tmp_path / "ck" / "epoch_0000"))


def test_resume_continues_from_epoch(tmp_path):
    cfg = tiny_cfg()
    train_loader, _ = _loaders(cfg, n_train=2)  # one step an epoch
    model = fetch_model(cfg, "cpu")
    exp = Experiment(cfg, root=str(tmp_path / "logs2"))
    trainer = Trainer(cfg, model, exp)
    state = trainer.fit(train_loader, None, num_epochs=1)
    assert state.step == 1
    mu0 = state.tx.mu[0].clone()

    # resume: same ckpt dir, 2 total epochs -> one more epoch of steps; a
    # fresh model proves that weights and moments come from the file
    cfg2 = cfg.replace(resume_ckpt=os.path.join(trainer.ckpt.ckpt_dir,
                                                "last"))
    fresh = fetch_model(cfg2, "cpu", seed=7)
    trainer2 = Trainer(cfg2, fresh, exp)
    restored, epoch = trainer2.ckpt.restore(
        __import__("hands_tpu_torch.train.state", fromlist=["x"])
        .create_train_state(cfg2, fresh), "last")
    assert epoch == 1 and restored.tx.count == 1
    torch.testing.assert_close(restored.tx.mu[0], mu0, rtol=0, atol=0)
    state2 = trainer2.fit(train_loader, None, num_epochs=2)
    assert state2.step == 2 and state2.tx.count == 2  # 2 epochs x 1, not 3
    assert trainer2.timing["steps"] == 1


def test_mid_epoch_checkpointing_and_warm_start(tmp_path):
    cfg = tiny_cfg(save_every_steps=1)
    train_loader, _ = _loaders(cfg)
    model = fetch_model(cfg, "cpu")
    exp = Experiment(cfg, root=str(tmp_path / "logs3"))
    trainer = Trainer(cfg, model, exp)
    saves = []
    orig = trainer.ckpt.save_last
    trainer.ckpt.save_last = lambda s, e: (saves.append((s.step, e)),
                                           orig(s, e))[1]
    trainer.fit(train_loader, None, num_epochs=1)
    assert saves == [(1, 0), (2, 0), (2, 1)]  # during the epoch, then after
    assert trainer.ckpt.has_checkpoint("last")
    # warm start (--load_ckpt): parameters only, the optimiser starts anew
    warm_cfg = tiny_cfg(load_ckpt=os.path.join(trainer.ckpt.ckpt_dir, "last"))
    other = fetch_model(warm_cfg, "cpu", seed=11)
    t2 = Trainer(warm_cfg, other, Experiment(warm_cfg,
                                             root=str(tmp_path / "logs4")))
    seen = {}
    step = t2.train_step

    def spy(state, batch, gen):
        if not seen:
            seen["count"] = state.tx.count
            seen["w"] = next(iter(other.parameters())).detach().clone()
        return step(state, batch, gen)

    t2.train_step = spy
    want = torch.load(warm_cfg.load_ckpt, weights_only=True)["model"]
    t2.fit(_loaders(warm_cfg, n_train=2)[0], None, num_epochs=1)
    assert seen["count"] == 0
    first = next(iter(other.state_dict()))
    torch.testing.assert_close(seen["w"], want[first], rtol=0, atol=0)


def test_debug_stops_on_a_non_finite_loss_and_what_is_left_out(tmp_path):
    cfg = tiny_cfg(debug=True)
    train_loader, _ = _loaders(cfg)
    model = fetch_model(cfg, "cpu")
    trainer = Trainer(cfg, model, Experiment(cfg, root=str(tmp_path / "a")))
    with torch.no_grad():
        next(iter(model.parameters())).fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="step 1"):
        trainer.fit(train_loader, None, num_epochs=1)
    # the overlays, once left out (queue 1 item 8), are drawn even from a
    # model gone non-finite: the drawing never ends a run
    images = trainer.visualize(None, _loaders(cfg)[1], 0)
    assert [n for n, _ in images] == [
        "0__targets_kps", "0__pred_kps", "0__rend_rvalid=1, lvalid=1"]
    # --load_backbone: a cli.convert_ckpt file of a reference-layout
    # ResNet-18 fills both backbones before the first step
    src, out = str(tmp_path / "resnet18.pth"), str(tmp_path / "r18.pt")
    ref = resnet_reference_sd((2, 2, 2, 2), np.random.RandomState(4))
    torch.save(ref, src)
    convert_main(["--src", src, "--arch", "resnet18", "--out", out])
    gcfg = tiny_cfg(use_glb_feat=True, load_backbone=out)
    gmodel = fetch_model(gcfg, "cpu")
    gtrainer = Trainer(gcfg, gmodel, trainer.exp)
    seen = {}
    step = gtrainer.train_step

    def spy(state, batch, gen):
        if not seen:
            seen.update({k: v.clone() for k, v in gmodel.state_dict().items()})
        return step(state, batch, gen)

    gtrainer.train_step = spy
    gtrainer.fit(train_loader, None, num_epochs=1)
    for scope in ("hand_backbone", "glb_backbone"):
        torch.testing.assert_close(
            seen[f"net.{scope}.stages.1.0.down_conv.weight"],
            ref["layer2.0.downsample.0.weight"], rtol=0, atol=0)
        torch.testing.assert_close(seen[f"net.{scope}.bn_stem.running_var"],
                                   ref["bn1.running_var"], rtol=0, atol=0)
    # one process and no group: fsdp changes nothing (JAX on one device);
    # the multi-process runs are tests/test_torch_multiprocess.py's
    alone = Trainer(tiny_cfg(fsdp=True), model, trainer.exp)
    assert alone.dp is None and not alone.fsdp and alone.mesh is None
    # a ("data", "model") mesh in one process trains as the JAX trainer
    # does there (it builds no mesh): the one-process step, unchanged; the
    # mesh over ranks is tests/test_torch_sharding_tp.py's
    from hands_tpu_torch.core.xdict import device_view
    from hands_tpu_torch.train.state import create_train_state

    mcfg = gcfg.replace(mesh_shape=(1, 2), mesh_axis_names=("data", "model"))
    meshed = Trainer(mcfg, gmodel, trainer.exp)
    assert meshed.dp is None and meshed.mesh is None
    inputs, targets, meta = next(iter(train_loader))
    before = {k: v.clone() for k, v in gmodel.state_dict().items()}
    logs = []
    for t in (Trainer(gcfg, gmodel, trainer.exp), meshed):
        gmodel.load_state_dict(before)
        logs.append({k: float(v) for k, v in t.train_step(
            create_train_state(t.cfg, gmodel),
            (inputs, targets, device_view(meta)),
            torch.Generator().manual_seed(0))[1].items()})
    assert logs[0] == logs[1] and np.isfinite(logs[0]["loss"])


# ------------------------------------------------------------------- parity
@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    kw = dict(TINY, tf_decoder=True, use_grasp_loss=True, lr=1e-7)
    jcfg, tcfg = jax_config("hands_light", **kw), default_config(
        "hands_light", **kw)

    def loaders(cfg, loader_cls, ds_cls, **extra):
        train = loader_cls(ds_cls(cfg, "train", length=8), cfg, 2,
                           is_train=False, num_workers=0, **extra)
        val = loader_cls(ds_cls(cfg, "val", length=3), cfg, 2,
                         is_train=False, drop_last=False, num_workers=0,
                         **extra)
        return train, val

    jtrain, jval = loaders(jcfg, JaxLoader, JaxSynthetic)
    jmodel = jax_fetch_model(jcfg)
    inputs, _, meta = jtrain.peek()
    from hands_tpu.core.xdict import device_view

    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), inputs, device_view(meta)))
    np_vars = fill_variables(shapes, seed=1)
    variables = jax.tree.map(jnp.asarray, np_vars)  # donated to the steps
    orig = jtrainer.create_train_state
    jtrainer.create_train_state = (
        lambda cfg, _, steps_per_epoch: orig(cfg, variables, steps_per_epoch))
    jexp = JaxExperiment(jcfg, root=str(tmp / "jax"))
    jtr = jtrainer.Trainer(jcfg, jmodel, jexp)
    try:
        jtr.fit(jtrain, jval, num_epochs=1)
    finally:
        jtrainer.create_train_state = orig

    model = fetch_model(tcfg, "cpu")
    model.load_state_dict(state_dict_from_jax(np_vars, model))
    ttrain, tval = loaders(tcfg, DeviceDataLoader, SyntheticRecordDataset,
                           device="cpu")
    texp = Experiment(tcfg, root=str(tmp / "port"))
    state = Trainer(tcfg, model, texp).fit(ttrain, tval, num_epochs=1)
    yield SimpleNamespace(
        ref=_rows(jexp.dir), got=_rows(texp.dir), state=state, jcfg=jcfg,
        jmodel=jmodel, jtrainer=jtr, jval=jval, jinputs=(inputs, meta),
        tcfg=tcfg, tval=tval, jdir=jexp.dir, tdir=texp.dir)
    shutil.rmtree(tmp, ignore_errors=True)


def test_trainer_matches_the_jax_trainer(both_runs):
    ref, got, state = both_runs.ref, both_runs.got, both_runs.state
    assert state.step == 4
    assert len(ref) == len(got) == 4  # two windows, the epoch time, val
    checked = 0
    for r, g in zip(ref, got):
        assert set(r) == set(g), set(r) ^ set(g)
        assert r["step"] == g["step"]
        for k in r:
            if k in ("step", "time", "epoch_time_s"):
                continue
            err = abs(g[k] - r[k]) / max(abs(r[k]), 1e-3)
            # the gradient norm runs back through BatchNorm statistics of
            # two images and squares every entry: 1.2e-3 observed
            bound = 5e-3 if k == "grad_norm__train" else 1e-3
            assert err <= bound, (k, g[k], r[k])
            checked += 1
    val = got[-1]
    assert "loss__val" in val and "metric.mpjpe/ra/h__val" in val
    assert sum(k.startswith("metric.") for k in val) >= 4
    assert all(np.isfinite(v) for v in val.values())
    assert "loss__train" in got[0] and "grad_norm__train" in got[0]
    assert checked > 30


def test_restore_params_also_restores_running_statistics(both_runs):
    """A deliberate divergence (ROADMAP queue 3, fault 1). The port's
    ``restore_params`` (``cli.evaluate --infer_ckpt``, warm start) loads the
    running statistics with the parameters; the JAX one returns the
    parameters only, so ``hands_tpu/cli/evaluate.py`` evaluates a ResNet on
    the ``batch_stats`` of a fresh init. The tiny WildHands checkpoints of the
    parity run, each evaluated as its package's ``cli.evaluate`` does: the
    port's equals its trainer's ``loss__val``, the JAX one's does not."""
    from hands_tpu.core.xdict import device_view
    from hands_tpu.train.checkpoint import CheckpointManager as JaxCkpt
    from hands_tpu.train.state import create_train_state as jax_state
    from hands_tpu_torch.train.state import create_train_state

    r = both_runs
    j_logged = r.ref[-1]["loss__val"]
    t_logged = r.got[-1]["loss__val"]

    inputs, meta = r.jinputs
    variables = r.jmodel.init(jax.random.PRNGKey(0), inputs,
                              device_view(meta))
    state = jax_state(r.jcfg, variables)
    ckpt = JaxCkpt(os.path.join(r.jdir, "checkpoints"))
    restored = ckpt.restore_params(state.params, "last")
    assert set(restored) == set(state.params)  # parameters, nothing else
    j_eval = r.jtrainer.validate(state.replace(params=restored),
                                 r.jval)["loss"]

    model = fetch_model(r.tcfg, "cpu")
    untouched = CheckpointManager(os.path.join(r.tdir, "checkpoints")
                                  ).restore_params(model, "last")
    assert untouched == []  # running statistics included
    exp = Experiment(r.tcfg.replace(exp_key="restored"),
                     root=os.path.join(r.tdir, "eval"))
    t_eval = Trainer(r.tcfg, model, exp).validate(
        create_train_state(r.tcfg, model), r.tval)["loss"]

    assert abs(t_eval - t_logged) <= 1e-6 * abs(t_logged)
    assert abs(t_eval - j_logged) <= 1e-3 * abs(j_logged)  # the parity bound
    assert abs(j_eval - j_logged) > 1e-2 * abs(j_logged), (j_eval, j_logged)


def _queue1_titles():
    text = open(os.path.join(os.path.dirname(__file__), os.pardir,
                             "ROADMAP.md")).read()
    queue = text.split("### 1. Modules to port")[1].split("### 2.")[0]
    return {int(m.group(1)): " ".join(m.group(2).split()) for m in
            re.finditer(r"^(\d+)\. \*\*(.+?)\*\*", queue, re.M | re.S)}


def _left_out(what, where):
    """Call what the port has not ported yet; return its message."""
    from hands_tpu_torch.parallel.fsdp import shard_model
    from hands_tpu_torch.parallel.mesh import AxisGroup
    from hands_tpu_torch.parallel.sharding import shard_vit_tp

    two = AxisGroup(None, 0, 2)  # rank 0 of 2 model ranks: no collective

    def hamer(**kw):
        cfg = default_config("hamer_light", use_render_seg_loss=False, **kw)
        return fetch_model(cfg, "cpu", vit_variant="tiny")

    calls = {
        # tensor parallelism on the int8 blocks (K5, K6)
        "tp_int8": lambda: shard_vit_tp(
            hamer(compute_dtype="bfloat16", quant_int8=True), two),
        # FSDP over a tensor-parallel model (fsdp_tp_shardings)
        "fsdp_tp": lambda: shard_model(shard_vit_tp(hamer(), two), None),
    }
    with pytest.raises(NotImplementedError) as err:
        calls[what]()
    return str(err.value)


@pytest.mark.parametrize("what,title", [("tp_int8", "Parallel axes"),
                                        ("fsdp_tp", "Parallel axes")])
def test_what_is_left_out_names_its_roadmap_item(what, title, tmp_path):
    """ROADMAP queue 3, fault 3: every ``NotImplementedError`` of the port
    points at the ``ROADMAP.md`` queue 1 item that ports it."""
    titles = _queue1_titles()
    cited = [int(n) for n in re.findall(r"item (\d+)",
                                        _left_out(what, tmp_path))]
    assert cited and all(n in titles for n in cited), (cited, titles)
    assert any(title in titles[n] for n in cited), [titles[n] for n in cited]


# --------------------------------------------------------------- entry point
def _jax_evaluate_config(argv):
    """The config that ``hands_tpu/cli/evaluate.py`` builds from ``argv``,
    stopped before it builds the model."""
    import hands_tpu.models.registry as jax_registry
    from hands_tpu.cli import evaluate as jax_evaluate

    class Built(Exception):
        pass

    def stop(cfg, *args, **kwargs):
        raise Built(cfg)

    with mock.patch.object(jax_registry, "fetch_model", stop):
        with pytest.raises(Built) as built:
            jax_evaluate.main(argv)
    return built.value.args[0]


@pytest.mark.parametrize("argv", [
    ["--eval_on", "synthetic"],
    ["--debug", "--eval_on", "epic"],
    ["--eval_on", "epic", "-f"],
    ["--debug"],
    ["--eval_on", "synthetic", "--valsplit", "smallval"],
])
def test_flags_follow_the_reference_order(argv):
    """ROADMAP queue 3, fault 2: ``--eval_on`` first, then ``--debug`` or
    ``-f`` win, as in ``hands_tpu/cli/evaluate.py``; the evaluation config
    of the port equals the JAX one in every field the two share."""
    from hands_tpu_torch.cli import _args

    want = _jax_evaluate_config(argv)
    got, device = _args.parse(argv + ["--device", "cpu"])
    assert device == "cpu"
    assert got.val_dataset == want.val_dataset
    assert got.use_render_seg_loss == want.use_render_seg_loss
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    shared = (set(g) & set(w)) - {"dataset"}  # --debug sets the port's too
    assert {k: g[k] for k in shared} == {k: w[k] for k in shared}


def test_cli_train_reads_eval_on_a_divergence():
    """``hands_tpu/cli/train.py`` reads no ``--eval_on``; the port's
    ``cli.train`` does (a listed divergence), so that a run on ``--dataset
    synthetic`` can name its validation set; ``--debug`` still wins."""
    from hands_tpu_torch.cli import _args

    cfg, _ = _args.parse(["--dataset", "synthetic", "--eval_on", "synthetic",
                          "--device", "cpu"])
    assert (cfg.dataset, cfg.val_dataset) == ("synthetic", "synthetic")
    cfg, _ = _args.parse(["--debug", "--dataset", "epic", "--eval_on",
                          "epic", "--device", "cpu"])
    assert (cfg.dataset, cfg.val_dataset) == ("synthetic", "synthetic")
    assert not cfg.use_render_seg_loss


SMALL = dict(backbone="resnet18", compute_dtype="float32", img_res=160,
             img_res_ds=160, use_glb_feat=False, logger="none")


def test_cli_train_debug_epoch_then_evaluate_and_resume(tmp_path, capsys):
    """``cli.train --debug`` on the CPU at a small size: one epoch of six steps
    of two images at lr 2e-3. The first window (two steps) holds the first
    Adam update, which overshoots the weak-perspective scale from its zero
    start (loss 9e5); the second window lies two orders below it and the
    third a further seven times (4860, 652). Then
    ``cli.evaluate --infer_ckpt`` on the ``last`` checkpoint and a resumed
    run that starts at the saved epoch. ``--profile_steps 2`` writes a Chrome
    trace of two steps beside the logs."""
    root = str(tmp_path / "logs")
    over = dict(SMALL, batch_size=2, test_batch_size=4, eval_every_epoch=1,
                exp_key="dbg")
    args = ["--debug", "--device", "cpu", "--no_vis", "--lr", "2e-3",
            "--log_every", "2", "--profile_steps", "2"]
    state = cli_train.main(args, log_root=root, overrides=over)
    assert state.step == 6  # minitrain: 12 records
    exp_dir = os.path.join(root, "dbg")
    rows = _rows(exp_dir)
    losses = [r["loss__train"] for r in rows if "loss__train" in r]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] / 10.0, losses
    assert losses[2] < losses[1] < losses[0], losses
    val = [r for r in rows if "loss__val" in r]
    assert len(val) == 1
    ck = os.path.join(exp_dir, "checkpoints")
    assert sorted(os.listdir(ck)) == ["epoch_0000", "last", "scores.json"]
    trace = json.load(open(os.path.join(exp_dir, "trace", "trace.json")))
    assert len(trace["traceEvents"]) > 100  # the run's steps 3 and 4
    args_json = json.load(open(os.path.join(exp_dir, "args.json")))
    assert args_json["dataset"] == "synthetic" and args_json["debug"]
    assert not args_json["use_render_seg_loss"]  # --debug turns it off

    # the same weights on the same batches: the trainer's loss__val
    capsys.readouterr()
    metrics = cli_evaluate.main(
        ["--debug", "--device", "cpu", "--infer_ckpt",
         os.path.join(ck, "last")], log_root=str(tmp_path / "eval_logs"),
        overrides=dict(over, exp_key="ev"))
    printed = json.loads(capsys.readouterr().out)
    assert printed == metrics
    assert abs(metrics["loss"] - val[0]["loss__val"]) <= 1e-5 * abs(
        val[0]["loss__val"])
    for k, v in metrics.items():
        if k.startswith("metric."):
            assert abs(v - val[0][k + "__val"]) <= 1e-5 * max(abs(v), 1.0), k

    # resume: the epoch is done, so no step is taken and the count stays
    resumed = cli_train.main(
        args + ["--resume_ckpt", os.path.join(root, "dbg", "checkpoints",
                                              "last")],
        log_root=root, overrides=dict(over, exp_key=""))
    assert resumed.step == 6 and resumed.tx.count == 6
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert glob.glob(os.path.join(root, "*")) == [exp_dir]  # the key's reuse
