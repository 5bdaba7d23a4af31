"""Port parity of the iterative HMR heads: ``hands_tpu_torch.models.heads.
hmr`` (``TorchMHA``, ``HMRLayer``, ``TfHMRLayer``, ``HandHMR`` in both modes)
against ``hands_tpu.models.heads.hmr``, weights carried through the rules of
``hands_tpu_torch.utils.from_jax``.

Every leaf is a seeded numpy draw (the gain-0.01 decoders too, scaled so that
the refinement moves the pose visibly). Tolerance: 1e-5 absolute on every
output (f32 products of depth <= 1133 in another order, three refinement
iterations; observed below 3e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.models.heads import hmr as jhmr
from hands_tpu_torch.models.heads import hmr as thmr
from hands_tpu_torch.utils import from_jax

ATOL = 1e-5


def _fill(shapes, seed, decoder_gain=0.3):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            a = rng.randn(*leaf.shape) / np.sqrt(leaf.shape[0])
            if "['dec_" in name and "attn" not in name and \
                    "linear" not in name:
                a = a * decoder_gain
        else:
            a = rng.randn(*leaf.shape) * 0.1
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _load(tmodule, rules, params):
    flat = from_jax._flatten(params)
    sd = {}
    for port_key, jax_path, fn in rules:
        a = flat.pop(jax_path)
        sd[port_key[len("m."):]] = torch.from_numpy(
            np.array(a if fn is None else fn(a), np.float32))
    assert not flat, sorted(flat)  # every JAX leaf consumed
    assert set(sd) == set(tmodule.state_dict())  # every parameter filled
    tmodule.load_state_dict(sd)
    return tmodule.eval()


def test_torch_mha_matches_jax():
    rng = np.random.RandomState(0)
    q = rng.randn(2, 5, 32).astype(np.float32)
    kv = rng.randn(2, 7, 32).astype(np.float32)
    jm = jhmr.TorchMHA(32, num_heads=4)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(kv),
        jnp.asarray(kv)))
    variables = _fill(shapes, 1)
    ref = jm.apply(variables, jnp.asarray(q), jnp.asarray(kv),
                   jnp.asarray(kv))
    tm = _load(thmr.TorchMHA(32, num_heads=4),
               [(p, j[2:], f) for p, j, f in from_jax._mha("x", "m")],
               variables["params"])
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(kv),
                 torch.from_numpy(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("tf_decoder", [False, True])
def test_hand_hmr_matches_jax(tf_decoder):
    """``HandHMR`` with ``HMRLayer`` (a feature vector in) and with
    ``TfHMRLayer`` (a 3x3 map of 40 channels in, so that the (H, W) -> token
    flattening and the concat order of the init dict both matter)."""
    rng = np.random.RandomState(2)
    feat_dim = 24
    feat = (rng.randn(3, 3, 3, 40) if tf_decoder
            else rng.randn(3, feat_dim)).astype(np.float32)
    jm = jhmr.HandHMR(feat_dim, tf_decoder=tf_decoder)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(feat)))
    variables = _fill(shapes, 3)
    ref = jm.apply(variables, jnp.asarray(feat))
    tm = thmr.HandHMR(feat_dim, in_dim=feat.shape[-1], tf_decoder=tf_decoder)
    tm = _load(tm, [(p, j[2:], f)
                    for p, j, f in from_jax._hand_hmr("x", "m", tm)],
               variables["params"])
    with torch.no_grad():
        got = tm(torch.from_numpy(feat))
    assert set(got) == set(ref) == {"pose", "shape", "cam_t.wp",
                                    "cam_t.wp.init"}
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)
    assert got["pose"].shape == (3, 16, 3, 3)
    # the refinement moved off its start: identity pose, zero shape
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (3, 16, 3, 3))
    assert float(np.abs(got["pose"].numpy() - eye).max()) > 1e-2
    assert float(got["shape"].abs().max()) > 1e-2
    assert not np.allclose(got["cam_t.wp"].numpy(),
                           got["cam_t.wp.init"].numpy())
    # and the poses are rotations
    R = got["pose"].numpy().reshape(-1, 3, 3)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-5)


@pytest.mark.parametrize("layer", ["HMRLayer", "TfHMRLayer"])
def test_refinement_layers_match_jax(layer):
    """Each layer alone, from an init dict in the order the head builds it
    (pose_6d, shape, cam_t_wp), which is not the specs' order."""
    rng = np.random.RandomState(4)
    B = 2
    init = {"pose_6d": rng.randn(B, 96).astype(np.float32),
            "shape": rng.randn(B, 10).astype(np.float32),
            "cam_t_wp": rng.randn(B, 3).astype(np.float32)}
    if layer == "HMRLayer":
        feat = rng.randn(B, 20).astype(np.float32)
        jm = jhmr.HMRLayer(feat_dim=20, mid_dim=64)
        tm = thmr.HMRLayer(20, mid_dim=64)
        names = ["refine0", "refine1"]
        rules = []
    else:
        feat = rng.randn(B, 2, 3, 20).astype(np.float32)
        jm = jhmr.TfHMRLayer(mid_dim=64)
        tm = thmr.TfHMRLayer(20, mid_dim=64)
        names = ["feat_mlp_dense", "vector_mlp_dense", "dec_linear1",
                 "dec_linear2", "enc_linear1", "enc_linear2"]
        rules = [r for n in ("dec_self_attn", "dec_cross_attn",
                             "enc_self_attn")
                 for r in from_jax._mha(n, f"m.{n}")]
    jinit = {k: jnp.asarray(v) for k, v in init.items()}
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(feat), jinit))
    variables = _fill(shapes, 5)
    ref = jm.apply(variables, jnp.asarray(feat), jinit)
    rules += [r for n in names for r in from_jax._dense(n, f"m.{n}")]
    rules += [r for k in thmr.HAND_SPECS
              for r in from_jax._dense(f"dec_{k}", f"m.dec.{k}")]
    tm = _load(tm, rules, variables["params"])
    with torch.no_grad():
        got = tm(torch.from_numpy(feat),
                 {k: torch.from_numpy(v) for k, v in init.items()})
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)
        assert float(np.abs(got[k].numpy() - init[k]).max()) > 1e-3, k
