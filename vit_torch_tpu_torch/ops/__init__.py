"""Attention dispatch (``attention``) and the hand-written CUDA kernels with
their plain versions (``flash_attention``), built by ``_build``.

Nothing is re-exported here: the ``flash_attention`` function would shadow
the module of the same name, whose launch counter callers read."""
