"""crypto_rec_tpu_torch — the PyTorch / NVIDIA Hopper port of crypto_rec_tpu.

Mirrors the JAX package's module layout: the counterpart of
`crypto_rec_tpu/X/Y.py` is `crypto_rec_tpu_torch/X/Y.py`.  Plain tensor
code is PyTorch; each Pallas kernel of the JAX package is a hand-written
CUDA kernel for sm_90a under `csrc/`, built with nvcc at first use.  The
device of the tensors picks the path: a CUDA tensor goes to the kernel (or
raises), a CPU tensor to the kernel's plain PyTorch version.  The package
never imports JAX.
"""

__version__ = "0.1.0"

from crypto_rec_tpu_torch.config import RecConfig, load_config  # noqa: F401
