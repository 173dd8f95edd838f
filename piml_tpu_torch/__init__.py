"""PyTorch/CUDA port of the piml_tpu crowd simulator.

The JAX package ``piml_tpu`` is the reference; this package keeps its
module paths and function names, imports ``torch`` and never JAX, and runs
the neighbour selection through hand-written CUDA kernels (``csrc/``) on
an NVIDIA H100.

float32 matrix products run in full float32: TF32 is switched off here
(it keeps ~3 decimal digits and would move neighbour-feature MLP outputs
far beyond the tolerances the tests hold the port to).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
