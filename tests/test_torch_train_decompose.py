"""``hands_tpu_torch.cli.train_decompose`` on the CPU at small sizes: the
tiny ViT HaMeR (depth 2, C 128, 2 heads, bf16 with f32 masters, the K4
path's twins) and the tiny WildHands (ResNet-18 at 160^2, the mask loss off:
its splat twin alone takes seconds on the CPU), one and two images a
step.

The tool's rows run and are named and positive; its derived rows are there;
and the step it decomposes is ``make_train_step``'s: the ``grad`` row's
loss and gradients equal those the step hands its optimiser, bit for bit,
and ``opt_only`` on them leaves the parameters where the step leaves them.
The times here are the CPU's and stand for nothing on the card.
"""

import copy
import json

import pytest
import torch

from hands_tpu_torch.cli import train_decompose as td
from hands_tpu_torch.train.step import make_train_step

# (images a step, Setup's keywords); WildHands' BatchNorm wants two
CASES = {
    "hamer_light": (1, dict(vit="tiny", img_res=64)),
    "hands_light": (2, dict(backbone="resnet18", img_res=160,
                            overrides=dict(use_render_seg_loss=False))),
}
HAMER_ROWS = ("trunk_grad_ckpt", "trunk_grad_plain", "trunk_no_blocks")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", list(CASES))
def test_rows_are_named_and_positive(method, capsys):
    batch, kw = CASES[method]
    out = td.run(method, batch, 1, "cpu", **kw)
    rows, derived = out["rows"], out["derived"]
    want = ["gt_process", "fwd_eval", "fwd_train", "grad", "opt_only",
            "full_step", "trunk_grad"]
    if method == "hamer_light":
        want += list(HAMER_ROWS)
    assert list(rows) == want and out["where"] == "cpu"
    for name, r in rows.items():
        assert len(r["ms"]) == 1 and r["median"] > 0, name
        assert r["device_ms"] is None, name  # the CPU: no device time
    names = set(derived["rows"])
    assert {"backward", "outside: GT processing", "outside: optimiser",
            "outside: heads and losses"} <= names
    if method == "hamer_light":
        assert {"recompute (plain block + checkpoint)", "outside the blocks",
                "outside: patch embedding"} <= names
        assert derived["rows"]["recompute (K4, device)"] is None
    else:
        assert "backbones (forward and backward)" in names
    med = {k: r["median"] for k, r in rows.items()}
    assert derived["sum"] == pytest.approx(med["grad"] + med["opt_only"])
    printed = capsys.readouterr().out
    assert f"{method} train step, {batch} images" in printed
    assert "host clock" in printed and "device not measured" in printed
    json.dumps(out)  # what --json writes


@pytest.mark.parametrize("method", list(CASES))
def test_the_decomposed_step_is_make_train_steps(method):
    batch, kw = CASES[method]
    s = td.Setup(method, batch, "cpu", **kw)
    twin = copy.deepcopy(s.model)
    from hands_tpu_torch.train.state import create_train_state

    twin_state = create_train_state(s.cfg, twin)
    handed = []
    update = twin_state.tx.update
    twin_state.tx.update = lambda grads: (handed.append(
        [g.clone() for g in grads]), update(grads))[1]
    gen = torch.Generator().manual_seed(0)
    _, logs = make_train_step(twin, s.cfg)(twin_state, s.batch, gen)

    fns = td.pieces(s)
    total, _, grads = fns["grad"]()  # s.gen is seeded as gen was
    assert torch.equal(total.detach(), logs["loss"])
    assert len(grads) == len(handed[0])
    for g, h in zip(grads, handed[0]):
        assert torch.equal(g, h)
    s.state.apply_gradients(grads)  # opt_only
    for p, q in zip(s.state.params, twin_state.params):
        assert torch.equal(p, q)


def test_no_fallback_from_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.main(["--method", "hamer_light", "--vit", "tiny", "--batch", "1"])
