"""Hand-written CUDA kernels for Hopper (``sm_90a``) in place of the
reference package's Pallas kernels.

Each kernel ships as ``kernel.py`` (the ctypes wrapper of a
``csrc/<name>.cu`` source, with a launch counter), ``ref.py`` (the plain
PyTorch version of the same function) and ``ops.py`` (the entry point:
the kernel for a CUDA tensor, the plain version for a CPU tensor).
:mod:`repro_torch.kernels.build` compiles the sources at first use.

* ``hash_mix``     — 128-bit mixing digest of packed identifiers.
* ``sorted_probe`` — membership and lower bound of 64-bit keys in a sorted
                     digest table (the index lookup).
* ``tanimoto``     — batched Tanimoto top-k over packed fingerprints (the
                     similarity search).
"""

from .hash_mix.ops import hash_mix
from .sorted_probe.ops import sorted_probe
from .tanimoto.ops import tanimoto_topk
