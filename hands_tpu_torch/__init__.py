"""hands_tpu_torch — the PyTorch/CUDA port of ``hands_tpu`` for NVIDIA Hopper.

Mirrors ``hands_tpu``'s layout module by module, so each port module sits at
the same relative path as its JAX counterpart. Plain tensor code is PyTorch;
every Pallas kernel on a ported path becomes a hand-written CUDA kernel under
``csrc/``, built at first use, with a plain PyTorch twin beside it.

The package imports ``torch`` and never ``jax``/``flax``, and nothing of
``hands_tpu``: it keeps its own copies of the framework-free host code
(``config``, ``data/records``, ``data/datasets``).
"""

__version__ = "0.1.0"
