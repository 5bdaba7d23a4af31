"""The port never imports JAX: the machine with the card has none.

In a fresh interpreter (the test process itself has JAX loaded), import
``hands_tpu_torch``, build tiny HaMeR on the CPU, serve one batch, and check
that neither ``jax`` nor ``flax`` was imported along the way.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
import numpy as np
import torch
import hands_tpu_torch
from hands_tpu_torch.cli.demo import make_record, serve, serving_config
from hands_tpu_torch.models.registry import fetch_model

rng = np.random.RandomState(0)
recs = [make_record(f"r{i}", rng.randint(0, 256, (200, 240, 3), np.uint8),
                    np.asarray([20.5, 30.5, 150.5, 170.5], np.float32), None)
        for i in range(2)]
cfg = serving_config("hamer_light", "bfloat16", fused_block=True)
out = serve(recs, cfg, fetch_model(cfg, "cpu", seed=0, vit_variant="tiny"),
            "cpu")
assert out["pred.mano.vertices.r"].shape == (2, 778, 3)
assert torch.isfinite(out["pred.mano.j3d.cam.l"]).all()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not bad, bad
print("NOJAX_OK")
"""


def test_port_serves_without_importing_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout
