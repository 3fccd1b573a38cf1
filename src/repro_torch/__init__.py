"""PyTorch/CUDA port of the byte-offset indexing system.

A second package beside the JAX reference ``repro``: the same module
layout and names (``repro_torch/core/store.py`` is the counterpart of
``repro/core/store.py``), the same on-disk formats, and hand-written CUDA
kernels for Hopper in place of the Pallas kernels.  It imports nothing of
``repro`` and nothing of JAX.  Entry points take an explicit ``device``
and default to ``"cuda"`` (see :mod:`repro_torch.device`).
"""
