"""Parallelism over ``torch.distributed``, counterpart of
``vit_torch_tpu/parallel/``: the four-axis mesh (``mesh.py``), process
groups and rank utilities (``multihost.py``), the sharded steps and
checkpoint layout (``api.py``), the partition rules, tensor parallelism
and FSDP2 (``partition.py``), the GPipe pipeline (``pipeline.py``) and
the autograd-aware collectives the modules call (``collectives.py``).
Ring attention is ``ops/ring_attention.py``.  Import the modules
directly: the models import ``collectives`` and the rest imports the
models."""
