"""Hand-written CUDA kernels for Hopper (``sm_90a``) in place of the
reference package's Pallas kernels.

Each kernel ships as ``kernel.py`` (the ctypes wrapper of a
``csrc/<name>.cu`` source, with a launch counter), ``ref.py`` (the plain
PyTorch version of the same function) and ``ops.py`` (the entry point:
the kernel for a CUDA tensor, the plain version for a CPU tensor).
:mod:`repro_torch.kernels.build` compiles the sources at first use.
``flash_attention`` and ``ssd_scan``, the two on the training path, are
differentiable: ``flash_attention/grad.py`` holds the attention's
``torch.autograd.Function`` (forward by the kernel, backward in PyTorch
ops) and ``ssd_scan/ops.py`` the scan's (backward by the same kernel).

* ``hash_mix``     — 128-bit mixing digest of packed identifiers.
* ``sorted_probe`` — membership and lower bound of 64-bit keys in a sorted
                     digest table (the index lookup).
* ``tanimoto``     — batched Tanimoto top-k over packed fingerprints (the
                     similarity search).
* ``flash_attention`` — causal / sliding-window GQA attention with an
                     online softmax (the LM prefill).
* ``ssd_scan``     — the Mamba2 SSD inter-chunk state scan (the SSM and
                     hybrid prefill).
* ``sample``       — a categorical draw per row of logits with
                     ``jax.random``'s threefry bits (the sampled decode
                     step); no Pallas kernel: the reference leaves it to
                     XLA's fusion.
"""

from .flash_attention.ops import flash_attention
from .hash_mix.ops import hash_mix, hash_mix_u64
from .sample.ops import sample
from .sorted_probe.ops import sorted_probe
from .ssd_scan.ops import ssd_scan
from .tanimoto.ops import tanimoto_topk
