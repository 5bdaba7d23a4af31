"""The port's ``CheckpointManager`` (``hands_tpu_torch.train.checkpoint``):
round trip of a full train state, top-k eviction with the same
``scores.json`` as the JAX manager, warm start tolerant of missing keys."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from hands_tpu_torch.config import default_config
from hands_tpu_torch.data.synthetic import make_batch
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.train.checkpoint import CheckpointManager
from hands_tpu_torch.train.state import create_train_state
from hands_tpu_torch.train.step import make_train_step

KW = dict(backbone="resnet18", compute_dtype="float32", use_glb_feat=False,
          use_render_seg_loss=False, use_grasp_loss=False, img_res=160,
          img_res_ds=160)


@pytest.fixture(autouse=True)
def free_checkpoints(tmp_path):
    """A checkpoint of even this tiny model (weights and two Adam moments)
    takes 270 MB: remove each test's files as soon as it is done."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six workers side by side, and
    eight threads each stall one another at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trained_state(acc_grad=1, steps=3, seed=0):
    cfg = default_config("hands_light", acc_grad=acc_grad, **KW)
    model = fetch_model(cfg, "cpu", seed=seed)
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    batch = make_batch(cfg, 2, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        state, _ = step(state, batch, gen)
    return cfg, model, state


def _snapshot(state):
    tx = state.tx
    tensors = {f"model.{k}": v.clone() for k, v in
               state.model.state_dict().items()}
    for name in ("mu", "nu", "acc"):
        for i, t in enumerate(getattr(tx, name) or []):
            tensors[f"{name}.{i}"] = t.clone()
    return tensors, (state.step, tx.count, tx.mini_step)


@pytest.mark.parametrize("acc_grad,steps", [(1, 2), (2, 1)])
def test_full_state_round_trip_is_bit_equal(tmp_path, acc_grad, steps):
    cfg, model, state = _trained_state(acc_grad, steps)
    want, counters = _snapshot(state)
    assert counters == (steps, steps // acc_grad, steps % acc_grad)
    ckpt = CheckpointManager(str(tmp_path / "ckpts"))
    ckpt.save_last(state, epoch=3)
    assert ckpt.has_checkpoint("last") and not ckpt.has_checkpoint("best")
    params_before = [p.data_ptr() for p in state.params]

    # a later in-place step must not reach the saved file
    step = make_train_step(model, cfg)
    state, _ = step(state, make_batch(cfg, 2, seed=1, device="cpu"),
                    torch.Generator().manual_seed(1))
    moved, _ = _snapshot(state)
    assert any(not torch.equal(moved[k], want[k]) for k in want)

    restored, epoch = ckpt.restore(state, "last")
    assert epoch == 3 and restored is state
    got, counters_after = _snapshot(restored)
    assert counters_after == counters
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # loaded into the live tensors: the optimiser still owns the parameters
    assert [p.data_ptr() for p in state.params] == params_before
    assert all(p is q for p, q in zip(state.params, model.parameters()))
    # a fresh model and state take the same checkpoint
    other = fetch_model(cfg, "cpu", seed=5)
    fresh = create_train_state(cfg, other)
    fresh, _ = ckpt.restore(fresh, "last")
    for (k, a), b in zip(model.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), k
    assert fresh.tx.count == counters[1]


def test_restore_refuses_another_accumulation(tmp_path):
    cfg, model, state = _trained_state(acc_grad=2, steps=1)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_last(state, 0)
    plain = create_train_state(cfg.replace(acc_grad=1), model)
    with pytest.raises(ValueError, match="accumulation"):
        ckpt.restore(plain, "last")


def test_top_k_eviction_and_scores_match_jax(tmp_path):
    """The same sequence of scores through both managers: the same
    ``scores.json`` and the same surviving names."""
    import jax.numpy as jnp

    from hands_tpu.train.checkpoint import CheckpointManager as JaxManager

    class JaxState:  # what the JAX manager's payload reads
        step = jnp.asarray(0)
        params = {"w": jnp.zeros(2)}
        batch_stats = {}
        opt_state = {"mu": jnp.zeros(2)}

    cfg, model, state = _trained_state(steps=0)
    jm = JaxManager(str(tmp_path / "jax"), top_k=2)
    tm = CheckpointManager(str(tmp_path / "port"), top_k=2)
    for epoch, score in [(0, 5.0), (1, 3.0), (2, 4.0), (3, 1.0), (4, 9.0)]:
        jm.save_top_k(JaxState(), epoch, score)
        tm.save_top_k(state, epoch, score)
        ref = json.load(open(tmp_path / "jax" / "scores.json"))
        got = json.load(open(tmp_path / "port" / "scores.json"))
        assert got == ref
        for name in [f"epoch_{e:04d}" for e in range(epoch + 1)]:
            assert tm.has_checkpoint(name) == jm.has_checkpoint(name), name
    assert set(got) == {"epoch_0003", "epoch_0001"}
    assert sorted(os.listdir(tmp_path / "port")) == [
        "epoch_0001", "epoch_0003", "scores.json"]
    # a new manager on the same directory reads the scores back
    again = CheckpointManager(str(tmp_path / "port"), top_k=2)
    again.save_top_k(state, 5, 0.5)
    assert set(json.load(open(tmp_path / "port" / "scores.json"))) == {
        "epoch_0005", "epoch_0003"}
    assert not again.has_checkpoint("epoch_0001")


def test_restore_params_tolerates_missing_keys(tmp_path):
    cfg, model, state = _trained_state(steps=1)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_last(state, 1)
    # a model with the grasp classifier on: more keys than the checkpoint
    big_cfg = cfg.replace(use_grasp_loss=True)
    big = fetch_model(big_cfg, "cpu", seed=9)
    before = {k: v.clone() for k, v in big.state_dict().items()}
    untouched = ckpt.restore_params(big, "last")
    saved = model.state_dict()
    assert untouched and all(k not in saved for k in untouched)
    for k, v in big.state_dict().items():
        if k in saved:
            assert torch.equal(v, saved[k]), k
        else:
            assert torch.equal(v, before[k]), k
    assert np.isfinite(sum(float(v.float().sum()) for v in
                           big.state_dict().values()))
