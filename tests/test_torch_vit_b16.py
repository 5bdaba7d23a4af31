"""WildHands with the ``vit_b_16`` backbone (``models/backbones/vit.py:
VitB16Spatial``) against the JAX package on the CPU, B = 1, in f32 and in
bf16 (where the port's blocks take the kernel route, whose CPU twin is the
plain block); every Flax leaf a numpy draw carried by ``utils.from_jax``.

Tolerances: f32 predictions 1e-4 of each output's scale (max(|ref|.max(),
1)); bf16 ones 2e-2 of it (the JAX side compiled without excess
precision).
"""

import pytest
import torch

from test_torch_families import BF16_RTOL, NO_EXCESS, run_pair
from test_torch_hands_light import RTOL, max_rel


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype,bound", [("float32", RTOL),
                                         ("bfloat16", BF16_RTOL)])
def test_wildhands_vit_b16_matches_jax(dtype, bound):
    """Two ViT-B/16s (224^2: 196 tokens, a 2 px padded patch embedding) with
    their conv adapters; in bf16 the port's blocks take the kernel route,
    whose CPU twin is the plain block."""
    ref, got, model = run_pair("hands_light",
                               dict(backbone="vit_b_16", compute_dtype=dtype),
                               1, options=NO_EXCESS)
    vit = model.net.hand_backbone.vit
    assert len(vit.blocks) == 12 and vit.pos_embed.shape == (1, 196, 768)
    assert vit.blocks[0].fused_train == (dtype == "bfloat16")
    worst, per_key = max_rel(ref, got, per_tensor=True)
    assert worst <= bound, per_key
