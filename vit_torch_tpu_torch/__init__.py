"""vit_torch_tpu_torch — the PyTorch / CUDA port of ``vit_torch_tpu`` for
one NVIDIA H100.

The JAX package stays the reference; this package keeps its structure and
names.  Plain tensor work is PyTorch; each Pallas TPU kernel on a ported
path is a CUDA kernel written by hand for Hopper (``csrc/``), built with
``nvcc`` on first use (``ops/_build.py``).

- ``models/``     the ViT family of the model zoo
- ``ops/``        attention dispatch and the flash-attention kernel
- ``checkpoint/`` JAX parameter trees and torch checkpoints into the models
- ``data/``       normalisation constants and the eval resize
- ``serving/``    classifier bundles and the micro-batching HTTP server
- ``cli/``        ``export`` and ``serve`` entry points

It imports nothing of JAX or of ``vit_torch_tpu``.
"""

__version__ = "0.1.0"
