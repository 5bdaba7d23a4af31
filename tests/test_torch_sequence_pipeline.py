"""Sequence-parallel attention and the GPipe pipeline of the port
(``parallel/sequence.py``, ``parallel/pipeline.py``, the ViT's ``ring``) on
four CPU ranks of one gloo group, against the JAX package's functions on the
same numpy inputs (tests/test_sharding_sp_pp.py's cases and shapes).

One module fixture starts four ranks of this file (``parallel/launch.py:
run_ranks``, one thread each, a free localhost port, a 120 s limit); the
2-rank cases run on the ``"model"`` lines of a (2, 2) ``("data", "model")``
mesh, the 4-rank ones on a (1, 4) mesh. Each rank holds its token block
(N / s) of q, k, v, and the JAX side shards the same arrays in
``shard_map``:

- ``sp_attention`` and ``ring_attention`` on 2 and 4 ranks against the JAX
  functions (and ``mha_reference``): 1e-5; the ring's gradients of
  ``sum(out^2)`` (every rank's loss, through ``ppermute``'s backward) on 4
  ranks against ``jax.grad`` of the JAX ring: 1e-4;
- the tiny f32 ViT trunk with ``ring`` on 4 ranks against the JAX trunk with
  ``ring_mesh`` (and the plain trunk): 2e-5 / rtol 1e-5;
- ``pipeline_apply`` at (stages, microbatches) (2, 3) and (4, 4) on the JAX
  test's tanh stage, and 4 stages of the JAX test's depth-8 block stack
  (LayerNorm, Dense, tanh GELU, Dense, residual; two blocks a stage), against
  the JAX ``pipeline_apply``: 1e-5.
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

RANKS, TIMEOUT = 4, 120.0
SP_SHAPE, RING_SHAPE, GRAD_SHAPE = (2, 32, 4, 16), (2, 64, 2, 8), (1, 16, 2, 8)
PIPES = ((2, 3), (4, 4))  # (stages, microbatches)
STACK = dict(depth=8, B=2, N=12, dim=32)
TRUNK_IMG = (2, 64, 64, 3)


# ------------------------------------------------------------- the ranks
def _shard(a, ax):
    """This rank's token block of a (B, N, ...) array."""
    n = a.shape[1] // ax.world
    return torch.from_numpy(np.ascontiguousarray(
        a[:, ax.rank * n:(ax.rank + 1) * n]))


def _case_attention(meshes, data, out):
    from hands_tpu_torch.parallel.sequence import (ring_attention,
                                                   sp_attention)

    for n, mesh in meshes.items():
        ax = mesh.axis("model")
        for fn in (sp_attention, ring_attention):
            for case in ("sp", "ring"):
                q, k, v = (_shard(data[f"{case}_{t}"], ax) for t in "qkv")
                out[f"{fn.__name__}/{case}/{n}"] = fn(q, k, v, ax).numpy()


def _case_ring_grads(meshes, data, out):
    from hands_tpu_torch.parallel.sequence import ring_attention

    ax = meshes[4].axis("model")
    q, k, v = (_shard(data[f"grad_{t}"], ax).requires_grad_(True)
               for t in "qkv")
    torch.sum(torch.square(ring_attention(q, k, v, ax))).backward()
    for name, t in zip("qkv", (q, k, v)):
        out[f"ring_grad/{name}"] = t.grad.numpy()


def _case_trunk(meshes, data, out):
    from hands_tpu_torch.models.backbones.vit import ViTBackbone
    from test_torch_sharding_tp import _load_vit

    bb = ViTBackbone("tiny", dtype=torch.float32, img_hw=TRUNK_IMG[1:3],
                     ring=meshes[4], ring_axis="model")
    _load_vit(bb, {k[6:]: data[k] for k in data.files
                   if k.startswith("trunk/")})
    with torch.no_grad():
        out["trunk"] = bb(torch.from_numpy(data["trunk_img"])).numpy()


def _stack_stage(blocks, x):
    """The JAX test's block (LayerNorm, Dense 2x, tanh GELU, Dense, +x) over
    this stage's blocks: (scale, bias, w0, b0, w1, b1) each, (in, out)
    kernels."""
    import torch.nn.functional as F

    from hands_tpu_torch.ops.vit_block import layernorm_f32

    for scale, bias, w0, b0, w1, b1 in blocks:
        h = F.gelu(layernorm_f32(x, scale, bias) @ w0 + b0,
                   approximate="tanh")
        x = x + (h @ w1 + b1)
    return x


def _case_pipeline(meshes, data, out):
    from hands_tpu_torch.parallel.pipeline import pipeline_apply

    for S, M in PIPES:
        ax = meshes[S].axis("model")
        w, b = (torch.from_numpy(data[f"pipe{S}_{t}"][ax.rank]) for t in "wb")
        xs = torch.from_numpy(data[f"pipe{S}_x"])
        out[f"pipe/{S}"] = pipeline_apply(
            lambda p, x: torch.tanh(x @ p[0] + p[1]), (w, b), xs, ax).numpy()
    ax = meshes[4].axis("model")
    per = STACK["depth"] // ax.world
    names = ("LayerNorm_0/scale", "LayerNorm_0/bias", "Dense_0/kernel",
             "Dense_0/bias", "Dense_1/kernel", "Dense_1/bias")
    blocks = [tuple(torch.from_numpy(data[f"stack/{k}"][i]) for k in names)
              for i in range(ax.rank * per, (ax.rank + 1) * per)]
    xs = torch.from_numpy(data["stack_x"])[None]
    out["stack"] = pipeline_apply(_stack_stage, blocks, xs, ax)[0].numpy()


def _rank_main(argv) -> int:
    import datetime

    import torch.distributed as dist

    from hands_tpu_torch.parallel.mesh import make_mesh

    rank, port, data_dir = int(argv[0]), argv[1], argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=RANKS,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    meshes = {2: make_mesh((2, 2), ("data", "model"), "cpu"),
              4: make_mesh((1, 4), ("data", "model"), "cpu")}
    data = np.load(os.path.join(data_dir, "inputs.npz"))
    out = {}
    for case in (_case_attention, _case_ring_grads, _case_trunk,
                 _case_pipeline):
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


def _inputs():
    """The JAX tests' draws, in their order."""
    rng = np.random.RandomState(0)
    d = {f"sp_{t}": rng.randn(*SP_SHAPE).astype(np.float32) for t in "qkv"}
    rng = np.random.RandomState(1)
    d.update(ring_q=rng.randn(*RING_SHAPE).astype(np.float32) * 2.0,
             ring_k=rng.randn(*RING_SHAPE).astype(np.float32) * 2.0,
             ring_v=rng.randn(*RING_SHAPE).astype(np.float32))
    rng = np.random.RandomState(2)
    d.update({f"grad_{t}": rng.randn(*GRAD_SHAPE).astype(np.float32)
              for t in "qkv"})
    for S, M in PIPES:
        rng = np.random.RandomState(3)
        d[f"pipe{S}_w"] = rng.randn(S, 16, 16).astype(np.float32) * 0.3
        d[f"pipe{S}_b"] = rng.randn(S, 16).astype(np.float32) * 0.1
        d[f"pipe{S}_x"] = rng.randn(M, 4, 16).astype(np.float32)
    d["stack_x"] = np.random.RandomState(4).randn(
        STACK["B"], STACK["N"], STACK["dim"]).astype(np.float32)
    d["trunk_img"] = np.random.RandomState(5).rand(*TRUNK_IMG).astype(
        np.float32)
    return d


@pytest.fixture(scope="module")
def jax_side(devices):
    """Every case's JAX output on the inputs, and the JAX weights."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from hands_tpu.models.backbones.vit import ViTBackbone
    from hands_tpu.parallel.mesh import make_mesh
    from hands_tpu.parallel.pipeline import pipeline_apply
    from hands_tpu.parallel.sequence import (mha_reference, ring_attention,
                                             sp_attention)
    from test_torch_sharding_tp import _flat

    d = _inputs()

    def mesh(n, name="model"):
        return make_mesh((n,), (name,), devices=devices[:n])

    ref = {}
    for case in ("sp", "ring"):
        qkv = [jnp.asarray(d[f"{case}_{t}"]) for t in "qkv"]
        ref[f"mha/{case}"] = np.asarray(mha_reference(*qkv))
        for n in (2, 4):
            for fn in (sp_attention, ring_attention):
                ref[f"{fn.__name__}/{case}/{n}"] = np.asarray(jax.jit(
                    lambda a, b, c, f=fn, m=mesh(n): f(a, b, c, m))(*qkv))
    qkv = [jnp.asarray(d[f"grad_{t}"]) for t in "qkv"]
    grads = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(jnp.square(ring_attention(a, b, c, mesh(4)))),
        argnums=(0, 1, 2)))(*qkv)
    ref.update({f"ring_grad/{t}": np.asarray(g) for t, g in zip("qkv", grads)})

    img = jnp.asarray(d["trunk_img"])
    plain = ViTBackbone(variant="tiny", dtype=jnp.float32)
    variables = plain.init(jax.random.PRNGKey(0), img)
    ref["trunk_plain"] = np.asarray(plain.apply(variables, img))
    ringed = ViTBackbone(variant="tiny", dtype=jnp.float32,
                         ring_mesh=mesh(4), ring_axis="model")
    ref["trunk"] = np.asarray(jax.jit(ringed.apply)(variables, img))
    d.update({f"trunk/{k}": v for k, v in _flat(variables["params"]).items()})

    for S, M in PIPES:
        params = {"w": jnp.asarray(d[f"pipe{S}_w"]),
                  "b": jnp.asarray(d[f"pipe{S}_b"])}
        ref[f"pipe/{S}"] = np.asarray(jax.jit(
            lambda p, x, m=mesh(S, "pipe"): pipeline_apply(
                lambda q, h: jnp.tanh(h @ q["w"] + q["b"]), p, x, m))(
                params, jnp.asarray(d[f"pipe{S}_x"])))

    class Block(nn.Module):  # tests/test_sharding_sp_pp.py's block
        dim: int = 32

        @nn.compact
        def __call__(self, x):
            h = nn.LayerNorm()(x)
            h = nn.Dense(self.dim * 2)(h)
            h = nn.gelu(h)
            return x + nn.Dense(self.dim)(h)

    blk, x = Block(STACK["dim"]), jnp.asarray(d["stack_x"])
    keys = jax.random.split(jax.random.PRNGKey(0), STACK["depth"])
    stacked = jax.vmap(lambda k: blk.init(k, x)["params"])(keys)
    grouped = jax.tree.map(lambda a: a.reshape((4, 2) + a.shape[1:]),
                           stacked)

    def stage_fn(p, h):
        def body(h, pp):
            return blk.apply({"params": pp}, h), None
        return jax.lax.scan(body, h, p)[0]

    ref["stack"] = np.asarray(jax.jit(
        lambda p, xs: pipeline_apply(stage_fn, p, xs, mesh(4, "pipe")))(
            grouped, x[None]))[0]
    ref["stack_serial"] = np.asarray(jax.lax.scan(
        lambda h, p: (blk.apply({"params": p}, h), None), x, stacked)[0])
    d.update({f"stack/{k}": v for k, v in _flat(stacked).items()})
    return d, ref


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Every rank's tensors (the four ranks run once for the module)."""
    from hands_tpu_torch.parallel.launch import free_port, rank_env, run_ranks

    tmp = tempfile.mkdtemp()
    try:
        np.savez(os.path.join(tmp, "inputs.npz"), **jax_side[0])
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


def _tokens(ranks, key, n):
    """The token blocks of the first ``n`` ranks of a model line, joined:
    ranks (d, 0..n-1) are ranks 0..n-1 of the world on both meshes."""
    return np.concatenate([ranks[r][key] for r in range(n)], axis=1)


@pytest.mark.parametrize("fn", ["sp_attention", "ring_attention"])
@pytest.mark.parametrize("n", [2, 4])
def test_sequence_attention_matches_jax(jax_side, ranks, fn, n):
    _, ref = jax_side
    for case in ("sp", "ring"):
        got = _tokens(ranks, f"{fn}/{case}/{n}", n)
        np.testing.assert_allclose(got, ref[f"{fn}/{case}/{n}"], atol=1e-5)
        np.testing.assert_allclose(got, ref[f"mha/{case}"], atol=1e-5)


def test_ring_attention_grads_match_jax(jax_side, ranks):
    _, ref = jax_side
    for t in "qkv":
        np.testing.assert_allclose(_tokens(ranks, f"ring_grad/{t}", 4),
                                   ref[f"ring_grad/{t}"], atol=1e-4)


def test_ring_in_vit_trunk_matches_jax(jax_side, ranks):
    _, ref = jax_side
    for r in ranks:  # the gathered tokens: every rank holds the whole map
        np.testing.assert_allclose(r["trunk"], ref["trunk"], atol=2e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(r["trunk"], ref["trunk_plain"],
                                   atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("stages,micro", PIPES)
def test_pipeline_matches_jax(jax_side, ranks, stages, micro):
    _, ref = jax_side
    for r in ranks[:stages]:  # replicated over the stages
        np.testing.assert_allclose(r[f"pipe/{stages}"],
                                   ref[f"pipe/{stages}"], atol=1e-5)


def test_pipeline_of_block_stack_matches_jax(jax_side, ranks):
    _, ref = jax_side
    for r in ranks:
        np.testing.assert_allclose(r["stack"], ref["stack"], atol=1e-5)
        np.testing.assert_allclose(r["stack"], ref["stack_serial"],
                                   atol=1e-5)
