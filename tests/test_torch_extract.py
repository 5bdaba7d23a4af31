"""``cli.extract`` and ``cli.build_feat_split`` of the port against the JAX
package's on the CPU.

Both extract the synthetic validation split (``--debug``: ``minival``, six
records, batches of 4, the second padded) with the same WildHands ResNet-18
variables, a numpy draw for every leaf: the port's CLI reads them from a
``torch.save`` checkpoint through ``--infer_ckpt``, the JAX CLI's model is
handed them at its ``init``. The crops are 160^2 (the CPU comparison size
of chip_smoke.py's training checks) in f32.
The per-sequence files hold the same image names and ``pred.*`` arrays
within ``test_torch_hands_light.RTOL`` of each array's scale, the serving
tolerance; the packed splits agree, and packing against another split's
image names raises.
"""

import os

import jax
import numpy as np
import pytest
import torch

import hands_tpu.config as jax_config_mod
import hands_tpu.models.registry as jax_registry
from hands_tpu.cli import build_feat_split as jax_pack
from hands_tpu.cli import extract as jax_extract
from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch as jax_make_batch
from hands_tpu_torch.cli import build_feat_split as pack
from hands_tpu_torch.cli import extract
from hands_tpu_torch.config import default_config
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_hands_light import RTOL, fill_variables

SMALL = dict(backbone="resnet18", compute_dtype="float32", img_res=160,
             img_res_ds=160)
ARGV = ["--method", "hands_light", "--debug", "--test_batch_size", "4"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """Both CLIs run in one working directory: {package: eval dir}."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("extract")
    jcfg = jax_config("hands_light", **SMALL)
    jmodel = jax_registry.fetch_model(jcfg)
    inputs, _, meta = jax_make_batch(jcfg, 2, seed=0)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), inputs, meta))
    variables = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, 1))
    model = fetch_model(default_config("hands_light", **SMALL), "cpu")
    model.load_state_dict(state_dict_from_jax(variables, model))
    ckpt = str(root / "last")
    torch.save({"model": model.state_dict()}, ckpt)

    class Initialised:
        """The JAX CLI's model, whose ``init`` hands over the shared
        variables instead of drawing its own op by op (365 small
        compilations, ~25 s)."""

        def init(self, *_):
            return variables

        def __call__(self, *args, **kwargs):
            return jmodel(*args, **kwargs)

    cwd = os.getcwd()
    construct = jax_config_mod.construct_args
    fetch = jax_registry.fetch_model
    try:
        os.chdir(root)
        jax_config_mod.construct_args = (
            lambda argv: construct(argv).replace(**SMALL))
        jax_registry.fetch_model = lambda cfg: Initialised()
        jax_dir = jax_extract.main(ARGV + ["--exp_key", "jax"])
        port_dir = extract.main(ARGV + [
            "--exp_key", "port", "--device", "cpu", "--infer_ckpt", ckpt],
            overrides=SMALL)
    finally:
        jax_config_mod.construct_args = construct
        jax_registry.fetch_model = fetch
        os.chdir(cwd)
    return {"jax": str(root / jax_dir), "port": str(root / port_dir)}


def load_dir(path):
    return {f: np.load(os.path.join(path, f), allow_pickle=True).item()
            for f in sorted(os.listdir(path))}


def test_extract_matches_jax(extracted):
    ref, got = load_dir(extracted["jax"]), load_dir(extracted["port"])
    assert list(got) == list(ref) == ["synthetic.npy"]
    for name in ref:
        r, g = ref[name], got[name]
        assert set(g) == set(r)
        assert g["imgname"] == r["imgname"] and len(r["imgname"]) == 6
        keys = [k for k in r if k.startswith("pred.")]
        assert {"pred.feat_vec", "pred.mano.beta.r", "pred.mano.cam_t.l"} <= \
            set(keys)
        for k in keys:
            a, b = np.asarray(r[k], np.float32), g[k]
            assert a.shape == b.shape and a.shape[0] == 6, k
            scale = max(float(np.abs(a).max()), 1.0)
            assert float(np.abs(a - b).max()) / scale <= RTOL, k


def test_build_feat_split_matches_jax(extracted, tmp_path):
    outs = {}
    for name, mod in (("jax", jax_pack), ("port", pack)):
        out = str(tmp_path / f"{name}.npy")
        assert mod.main(["--eval_p", extracted[name], "--out", out]) == out
        outs[name] = np.load(out, allow_pickle=True).item()
    assert set(outs["port"]) == set(outs["jax"])
    assert outs["port"]["imgname"] == outs["jax"]["imgname"]
    names = outs["jax"]["imgname"]
    split = str(tmp_path / "split.npy")
    np.save(split, {"imgnames": list(reversed(names))})
    pack.main(["--eval_p", extracted["port"], "--split_npy", split, "--out",
               str(tmp_path / "checked.npy")])
    np.save(split, {"imgnames": names[:-1] + ["other/000099.jpg"]})
    with pytest.raises(AssertionError, match="imgname mismatch"):
        jax_pack.main(["--eval_p", extracted["jax"], "--split_npy", split])
    with pytest.raises(ValueError, match="1 extra, 1 missing"):
        pack.main(["--eval_p", extracted["port"], "--split_npy", split])
    with pytest.raises(FileNotFoundError):
        pack.main(["--eval_p", str(tmp_path / "empty")])


def test_packed_arrays_match(extracted, tmp_path):
    """The packed port split holds its per-sequence rows in file order, within
    the serving tolerance of the JAX package's."""
    for name, mod in (("jax", jax_pack), ("port", pack)):
        mod.main(["--eval_p", extracted[name], "--out",
                  str(tmp_path / f"{name}.npy")])
    ref = np.load(tmp_path / "jax.npy", allow_pickle=True).item()
    got = np.load(tmp_path / "port.npy", allow_pickle=True).item()
    for k in (k for k in ref if k.startswith("pred.")):
        a = np.asarray(ref[k], np.float32)
        scale = max(float(np.abs(a).max()), 1.0)
        assert float(np.abs(a - got[k]).max()) / scale <= RTOL, k
