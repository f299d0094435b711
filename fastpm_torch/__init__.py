"""fastpm_torch: the PyTorch/CUDA port of fastpm_tpu.

A FastPM particle-mesh N-body framework for one NVIDIA GPU, or several
ranks of torch.distributed in x-slabs (fastpm_torch/parallel/): plain
torch for the array work, cuFFT through torch.fft, and hand-written CUDA
kernels (fastpm_torch/csrc/) for the CIC paint and readout, the sort's
merge and the device FOF. It imports
neither jax nor fastpm_tpu; the JAX package stays the reference its
tests hold it against.

Entry points run on the first CUDA device unless the caller passes
device="cpu"; with no GPU and no explicit device they raise.
"""

import torch

# float32 stays float32 on the card: no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .cosmology import Cosmology, GrowthInfo, FIDUCIAL  # noqa: E402
from .kdk import KickFactor, DriftFactor  # noqa: E402
from .timemachine import StateTable, Transition  # noqa: E402
