"""The trained-weights serving ladder (``hands_tpu_torch/cli/
trained_accuracy.py``) against the JAX package on the CPU, tiny ViT HaMeR
(depth 2, C 128, 2 heads) at ``img_res`` 160, bf16 with the recipe of
``scripts/vith_trained_accuracy.py:39``.

- The fresh-draw stream: batch i equals the JAX ``make_batch`` at seed
  ``TRAIN_SEED * 100003 + i`` (the pose and shape draws and the meta
  exactly; what is made from the MANO joints, images included, to 1e-4:
  the two packages' forwards round the joints apart by ulps), and no
  training seed is 0 or 7, the held-out batches' seeds.
- Two train steps on the stream from the same weights (carried by
  ``utils/from_jax``), batch size 2: each step's loss equals the JAX
  ``make_train_step``'s (plain blocks, the JAX tool's route; compiled with
  ``xla_allow_excess_precision=False``) to 2e-2 relative to max(|ref|,
  1e-3), the bf16 bound of tests/test_torch_train_step.py.
- The four rungs on the same weights and held-out batches, against the JAX
  tool's ``eval_mode`` (its eval step and forward in one program compiled
  as above, the Pallas blocks in interpret mode, the static scales from
  the JAX ``calibrate_scales``, compiled as one program, on the parameters
  merged onto the scale slots):
  - the task metrics to 2e-2 relative to max(|ref|, 1) for the bf16 and
    tanh-GELU forwards and 5e-2 for the int8 ones (tests/test_torch_hamer.py's
    bounds of the whole model);
  - each rung's ``mano.j3d.cam.r`` root-aligned (the camera's depth, ~125 m
    at this size, sets no scale then) to the JAX rung's at the whole
    model's bound on joints, 2e-2 relative to max(|ref|, 1) (observed
    <= 1.7 mm);
  - each int8 rung's drift against the bf16 rung, mean and max, in camera
    space as the tool prints it and root-aligned: above 0.1 mm on both
    sides (a rung that quantised nothing reads 0) and the port's within
    0.5x-2x of the JAX tool's (observed 0.68x-1.39x: the int8 steps that
    one bf16 ulp moves fall apart, test_torch_hamer.py);
  - the port's calibration scales to the JAX ones at
    tests/test_torch_calibration.py's bf16 bound on the maxima they come
    from (amax = 127 s): 3e-2 relative to max(|amax|, 1).
- ``--skip_train`` reloads the checkpoint that a run saved and gives
  bit-equal ladder rows.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.cli.calibrate import calibrate_scales as jax_calibrate
from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch as jax_make_batch
from hands_tpu.models.hamer_light import HamerLightModel as JaxHamer
from hands_tpu.ops import calibration as jcal
from hands_tpu.ops import vit_block_pallas as jvb
from hands_tpu.train import step as jstep
from hands_tpu.train.state import create_train_state as jax_create_state
from hands_tpu_torch.cli import trained_accuracy as ta
from hands_tpu_torch.cli.calibrate import calibrate_scales
from hands_tpu_torch.data.synthetic import make_batch
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_train_util import both, rel_err

SIZE = dict(img_res=160, img_res_ds=160)
NO_EXCESS = {"xla_allow_excess_precision": False}
BS = 2
LOSS_REL = 2e-2
METRIC_REL = {"bf16 fused_block (K3)": 2e-2, "int8 dynamic (K5)": 5e-2,
              "int8 + fast_gelu (K5)": 5e-2,
              "int8 static + fast_gelu (K6)": 5e-2}
SCALE_REL = 3e-2
JOINT_REL = 2e-2
DRIFT_FLOOR_MM = 0.1
DRIFT_RATIO = (0.5, 2.0)
_PALLAS = ("vit_block_fused_trainable", "vit_block_fused_int8",
           "vit_block_fused_int8_static")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_cfg(**kw):
    """The JAX tool's ``train_cfg`` at the test's size."""
    tcfg = ta.train_cfg(**SIZE, **kw)
    keys = ("compute_dtype", "use_render_seg_loss", "use_grasp_loss", "lr",
            "grad_clip", "fused_block", "quant_int8", "quant_int8_static",
            "fast_gelu", *SIZE)
    return jax_config("hamer_light", **{k: getattr(tcfg, k) for k in keys})


def test_recipe_is_the_jax_tools():
    cfg = ta.train_cfg()
    assert (cfg.compute_dtype, cfg.lr, cfg.grad_clip) == ("bfloat16", 5e-5,
                                                          1.0)
    assert not cfg.use_render_seg_loss and not cfg.use_grasp_loss
    assert [kw for _, kw in ta.LADDER] == [
        {}, {"quant_int8": True}, {"quant_int8": True, "fast_gelu": True},
        {"quant_int8_static": True, "fast_gelu": True}]


def stream_seeds(steps):
    """Batch i of ``SyntheticDataset(seed=TRAIN_SEED)`` is drawn from seed
    ``TRAIN_SEED * 100003 + i`` (``data/synthetic.py``, as in JAX)."""
    return [ta.TRAIN_SEED * 100003 + i for i in range(steps)]


@pytest.fixture(scope="module")
def stream():
    """The JAX ``make_batch`` of the stream's first two seeds, numpy."""
    return [jax_make_batch(jax_cfg(), BS, seed=seed, np_arrays=True)
            for seed in stream_seeds(2)]


def test_stream_draws_the_jax_batches_and_never_a_held_out_seed(stream):
    cfg = ta.train_cfg(fused_block=True, **SIZE)
    assert not set(stream_seeds(100_000)) & set(ta.EVAL_SEEDS)
    host = ta.FreshDraws(cfg, len(stream), BS, device="cpu")
    got = [b for b, _ in host.host_batches(None)]
    assert len(got) == len(stream)
    for batch, ref in zip(got, stream):
        for part, (g, r) in enumerate(zip(batch, ref)):
            assert set(g) == set(r)
            for k in r:
                # the draws themselves, and the meta; what is made from
                # the MANO joints (2D and 3D joints, boxes, angles, blobs)
                # carries the forwards' ulps
                exact = part == 2 or k.startswith(("mano.pose", "mano.beta"))
                np.testing.assert_allclose(
                    g[k], r[k], rtol=0 if exact else 1e-4,
                    atol=0 if exact else 1e-4, err_msg=k)
    inputs, targets, meta = host.device_batch(got[0], None, None)
    assert inputs["img"].shape == (BS, 160, 160, 3)
    assert all(torch.is_tensor(v) for v in meta.values())


@pytest.fixture(scope="module")
def weights():
    """Perturbed tiny-HaMeR JAX variables (every LayerNorm scale and bias
    off its init) and the held-out batches at batch size 2, numpy (the
    port's draws; both sides get these arrays)."""
    jcfg = jax_cfg()
    batches = [make_batch(ta.train_cfg(**SIZE), BS, seed=s, np_arrays=True)
               for s in ta.EVAL_SEEDS]
    jb, _ = both(batches[0])
    variables = jax.jit(JaxHamer(jcfg, vit_variant="tiny").init)(
        jax.random.PRNGKey(0), jb[0], jb[2])
    rng = np.random.RandomState(1)

    def perturb(path, p):
        p = np.asarray(p, np.float32)
        leaf = jax.tree_util.keystr(path)
        if leaf.endswith("['scale']") or leaf.endswith("['bias']"):
            p = p + rng.randn(*p.shape).astype(np.float32) * 0.05
        return p

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    return {"params": params}, batches


def test_two_train_steps_match_jax(weights, stream):
    variables, _ = weights
    jcfg = jax_cfg()
    model = fetch_model(ta.train_cfg(fused_block=True, **SIZE), "cpu",
                        vit_variant="tiny", param_dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(variables, model))
    _, got = ta.train(ta.train_cfg(fused_block=True, **SIZE), model, 2, BS,
                      device="cpu")

    jmodel = JaxHamer(jcfg, vit_variant="tiny")
    state = jax_create_state(jcfg, jax.tree.map(jnp.asarray, variables))
    step, ref = None, []
    for i, batch in enumerate(stream):
        jb, _ = both(batch)
        rng = jax.random.PRNGKey(i)
        if step is None:
            step = jstep.make_train_step(jmodel, jcfg, donate=False).lower(
                state, jb, rng).compile(NO_EXCESS)
        state, logs = step(state, jb, rng)
        ref.append(float(logs["loss"]))
    assert len(got["losses"]) == 2
    for g, r in zip(got["losses"], ref):
        assert abs(g - r) / max(abs(r), 1e-3) <= LOSS_REL, (got["losses"],
                                                           ref)


def _merge(dst, src):
    """``scripts/vith_trained_accuracy.py:_merge_params``: every leaf of src
    onto dst (dst may hold more, the static scales)."""
    out = dict(dst)
    for k, v in src.items():
        out[k] = _merge(dst.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _scale_slots(params):
    """The ``act_scale_*`` slots that the static model's init adds (ones,
    ``Block.quant_static``; the tool takes them from ``model.init``, which
    runs op by op here for ~20 s): (depth, C), the MLP's (depth, hidden)."""
    blk = params["backbone"]["blocks"]["block"]
    depth, c, hidden = np.shape(blk["mlp"]["Dense_0"]["kernel"])
    return {"backbone": {"blocks": {"block": {
        f"act_scale_{p}": np.ones((depth, hidden if p == "mlp2" else c),
                                  np.float32)
        for p in ("qkv", "proj", "mlp1", "mlp2")}}}}


def _jax_rung(kw, variables, batches):
    """The JAX tool's ``eval_mode`` of one rung at the tiny size: per batch
    the metrics of ``METRIC_KEYS`` and the forward's ``DRIFT_KEY``; with
    the static scales it calibrated."""
    jcfg = jax_cfg(fused_block=True, **kw)
    model = JaxHamer(jcfg, vit_variant="tiny")
    jbs = [both(b)[0] for b in batches]
    scales = None
    if jcfg.quant_int8_static:
        merged = _merge(_scale_slots(variables["params"]),
                        variables["params"])
        # one program: op by op the calibration forward takes ~16 s here
        scales = jax.jit(lambda v, batches: jax_calibrate(
            "hamer_light", v, batches, vit_variant="tiny"))(
                {"params": merged}, [(b[0], b[2]) for b in jbs])
        variables = {"params": jcal.inject_scales(merged, scales)}
    state = jax_create_state(jcfg, variables)
    # the tool's forward is the eval step's (GT processing leaves the inputs
    # as they are): one model in the program, its output caught as traced
    seen = {}

    class Caught:
        def __getattr__(self, name):
            return getattr(model, name)

        def __call__(self, *args, **kw):
            seen["out"] = model(*args, **kw)
            return seen["out"]

    eval_step = jstep.make_eval_step(Caught(), jcfg).__wrapped__

    def run(state, batch):
        metrics, _ = eval_step(state, batch)
        return ({k: metrics[k] for k in ta.METRIC_KEYS},
                seen["out"][ta.DRIFT_KEY])

    originals = {n: getattr(jvb, n) for n in _PALLAS}
    for n, fn in originals.items():
        setattr(jvb, n, lambda *a, fn=fn, **k: fn(*a, interpret=True, **k))
    try:
        fn = jax.jit(run).lower(state, jbs[0]).compile(NO_EXCESS)
    finally:
        for n, fn0 in originals.items():
            setattr(jvb, n, fn0)
    rows, outs = [], []
    for b in jbs:
        metrics, out = fn(state, b)
        rows.append({k: float(np.nanmean(np.asarray(v)))
                     for k, v in metrics.items()})
        outs.append(np.asarray(out, np.float32))
    return rows, outs, scales


def _root_aligned(j3d):
    return j3d - j3d[:, :1]


def _drifts(out, base):
    """(camera-space, root-aligned) |out - base| in mm."""
    return (np.abs(out - base) * 1000,
            np.abs(_root_aligned(out) - _root_aligned(base)) * 1000)


def test_ladder_matches_the_jax_tool(weights):
    variables, batches = weights
    model = fetch_model(ta.train_cfg(fused_block=True, **SIZE), "cpu",
                        vit_variant="tiny", param_dtype=torch.float32)
    sd = state_dict_from_jax(variables, model)
    tbatches = [both(b)[1] for b in batches]
    got, got_outs = ta.ladder(sd, tbatches, vit="tiny", device="cpu", **SIZE)
    assert [r["rung"] for r in got] == [tag for tag, _ in ta.LADDER]

    ref_outs = port_ref = None
    for (tag, kw), rung, port in zip(ta.LADDER, got, got_outs):
        rows, outs, scales = _jax_rung(kw, variables, batches)
        port = [o.numpy() for o in port]
        rel = METRIC_REL[tag]
        for g, r in zip(rung["rows"], rows):
            for k in ta.METRIC_KEYS:
                assert np.isfinite(g[k]) and abs(g[k] - r[k]) / max(
                    abs(r[k]), 1.0) <= rel, (tag, k, g[k], r[k])
        for p, out in zip(port, outs):
            err = rel_err(_root_aligned(p), _root_aligned(out))
            assert err <= JOINT_REL, (tag, err)
        if ref_outs is None:  # the bf16 rung: the drift's reference
            assert not any("drift_mean_mm" in g for g in rung["rows"])
            ref_outs, port_ref = outs, port
            continue
        for g, p, pb, out, base in zip(rung["rows"], port, port_ref, outs,
                                       ref_outs):
            cam, _ = _drifts(p, pb)  # the row is the port's own drift
            np.testing.assert_allclose(
                [g["drift_mean_mm"], g["drift_max_mm"]],
                [cam.mean(), cam.max()], rtol=1e-5)
            for mine, theirs in zip(_drifts(p, pb), _drifts(out, base)):
                for stat in (np.mean, np.max):
                    a, b = float(stat(mine)), float(stat(theirs))
                    assert a > DRIFT_FLOOR_MM and b > DRIFT_FLOOR_MM, (
                        tag, a, b)
                    assert DRIFT_RATIO[0] <= a / b <= DRIFT_RATIO[1], (
                        tag, stat.__name__, a, b)
        if scales is not None:
            own = calibrate_scales(
                "hamer_light", sd, [(b[0], b[2]) for b in tbatches],
                vit_variant="tiny", device="cpu")
            for p, v in scales.items():
                a = np.asarray(v)
                assert own[p].shape == a.shape
                # as amax = 127 s, relative to max(|amax|, 1)
                err = 127 * np.abs(own[p].numpy() - a) / np.maximum(
                    127 * np.abs(a), 1.0)
                assert err.max() <= SCALE_REL, (p, err.max())


def test_skip_train_reloads_the_checkpoint(tmp_path, capsys):
    argv = ["--device", "cpu", "--vit", "tiny", "--steps", "1", "--bs", "2",
            "--eval_batch", "2", "--ckpt_dir", str(tmp_path)]
    assert ta.main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (tmp_path / "last").is_file()
    assert ta.main(argv + ["--skip_train"]) == 0
    out = capsys.readouterr().out
    again = json.loads(out.strip().splitlines()[-1])
    assert "reloaded trained weights" in out and again["trained"] is None
    assert again["ladder"] == first["ladder"]
    assert again["untrained"] == first["untrained"]
    assert first["trained"]["steps"] == 1
    rows = [r for rung in first["ladder"] for r in rung["rows"]]
    assert len(rows) == 8 and all(
        np.isfinite(v) for r in rows for v in r.values())
