"""The EPIC-scale evaluation sweep (``hands_tpu_torch/cli/eval_sweep.py``)
against the JAX package's ``Trainer.validate`` on the CPU.

Tiny WildHands (ResNet-18, 160^2 crops, no global features, f32), numpy
weights carried to the port by ``utils/from_jax``, 37 synthetic val records:
- in batches of 16 (the last with 5 real rows and 11 padded ones) every
  metric and loss equals the JAX ``Trainer.validate`` over the JAX loader
  of the same records and weights to 1e-4 relative to max(|ref|, 1) (the
  eval step's bound, tests/test_torch_train_step.py (f); the two packages'
  synthetic labels differ by MANO ulps), and the padded rows are NaN;
- in one batch of 37 (no padding) the per-image metrics (not the losses,
  means of batch means) equal the batched sweep's to the sweep's own
  agreement bound, ``eval_sweep.AGREE`` * max(1, |v|); the
  packed route equals the record route exactly;
- the sweep's two epochs agree exactly (the CPU is deterministic);
- the CLI runs at its default bf16 and full crop size.
"""

import os

import numpy as np
import pytest
import torch

import jax

from hands_tpu.config import default_config as jax_config
from hands_tpu.core.xdict import device_view as jax_device_view
from hands_tpu.data.datasets import SyntheticRecordDataset as JaxSynthetic
from hands_tpu.data.device_pipeline import DeviceDataLoader as JaxLoader
from hands_tpu.models.registry import fetch_model as jax_fetch_model
from hands_tpu.train.state import create_train_state as jax_create_state
from hands_tpu.train.trainer import Trainer as JaxTrainer
from hands_tpu.utils.experiment import Experiment as JaxExperiment
from hands_tpu_torch.cli import eval_sweep
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_hands_light import fill_variables

N, BS = 37, 16
TINY = dict(backbone="resnet18", compute_dtype="float32", img_res=160,
            img_res_ds=160, use_glb_feat=False)
METRIC_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    return abs(got - ref) / max(abs(ref), 1.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX validation and the port's sweep of the same records and
    weights, in batches of 16."""
    tmp = tmp_path_factory.mktemp("sweep")
    jcfg = jax_config("hands_light", test_batch_size=BS,
                      use_render_seg_loss=False, logger="none", **TINY)
    jloader = JaxLoader(JaxSynthetic(jcfg, "val", length=N), jcfg, BS,
                        is_train=False, drop_last=False, num_workers=0)
    jmodel = jax_fetch_model(jcfg)
    inputs, _, meta = jloader.peek()
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), inputs, jax_device_view(meta)))
    np_vars = fill_variables(shapes, seed=1)
    state = jax_create_state(jcfg, jax.tree.map(np.asarray, np_vars))
    ref = JaxTrainer(jcfg, jmodel, JaxExperiment(
        jcfg, root=str(tmp / "jax"))).validate(state, jloader)

    net = fetch_model(eval_sweep.sweep_config(bs=BS, n=N, **TINY), "cpu")
    net.load_state_dict(state_dict_from_jax(np_vars, net))
    got = eval_sweep.sweep(N, BS, device="cpu", net=net, root=str(tmp),
                           **TINY)
    return ref, got, net, tmp


def test_sweep_matches_jax_validate(runs):
    ref, got, _, _ = runs
    metrics = got["metrics"]
    assert set(metrics) == set(ref) and "metric.pix_err/h" in metrics
    for k, v in ref.items():
        assert np.isfinite(metrics[k]) and _rel(metrics[k], v) <= METRIC_REL, (
            k, metrics[k], v)
    assert (got["batches"], got["tail_rows"]) == (3, N - 2 * BS)
    assert got["device_ms"] is None  # the CPU: no profiled epoch
    assert got["epochs"][0] == got["epochs"][1]


def test_padded_tail_is_nan(runs):
    _, got, _, _ = runs
    rows, tail = got["tail"], N - 2 * BS
    assert "pix_err/h" in rows and all(v.shape[0] == BS for v in rows.values())
    assert all(np.isnan(v[tail:]).all() for v in rows.values())
    assert np.isfinite(rows["pix_err/h"][:tail]).all()


def test_one_batch_without_padding_on_both_routes(runs):
    _, got, net, tmp = runs
    one = {packed: eval_sweep.sweep(N, N, packed=packed, device="cpu",
                                    net=net, root=str(tmp), **TINY)
           for packed in (True, False)}
    assert one[True]["metrics"] == one[False]["metrics"]
    for packed, out in one.items():
        assert (out["batches"], out["tail_rows"]) == (1, N)
        assert out["packed"] == packed
    # the per-image metrics; the losses are means of batch means, which a
    # padded batch weighs otherwise
    metrics = {k: v for k, v in got["metrics"].items()
               if k.startswith("metric.")}
    assert metrics
    for k, v in metrics.items():
        assert _rel(one[True]["metrics"][k], v) <= eval_sweep.AGREE, (k, v)
    assert sorted(os.listdir(tmp)) == ["jax"]  # the packs are removed


def test_cli_runs_on_the_cpu(capsys):
    assert eval_sweep.main(["--device", "cpu", "--n", "5", "--bs", "4",
                            "--backbone", "resnet18"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"metric": "epic5_e2e_eval"' in last and '"tail_rows": 1' in last
