"""PyTorch/CUDA port of pmf_tpu on an NVIDIA H100: the hybrid HPF-CAVI and
Gaussian-MF CAVI fits.

Imports torch only; nothing of JAX or of the JAX package.
"""

from pmf_tpu_torch.models.gaussian_mf import GaussianMF, GaussianMFConfig
from pmf_tpu_torch.models.hpf import HPF, HPFConfig

__all__ = ["GaussianMF", "GaussianMFConfig", "HPF", "HPFConfig"]
