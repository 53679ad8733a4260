"""PyTorch/CUDA port of pmf_tpu on an NVIDIA H100: the hybrid HPF-CAVI,
Gaussian-MF CAVI and Poisson-MF CAVI (plain and extended) fits.

Imports torch only; nothing of JAX or of the JAX package.
"""

from pmf_tpu_torch.models.gaussian_mf import GaussianMF, GaussianMFConfig
from pmf_tpu_torch.models.hpf import HPF, HPFConfig
from pmf_tpu_torch.models.poisson_mf import PoissonMF, PoissonMFConfig

__all__ = ["GaussianMF", "GaussianMFConfig", "HPF", "HPFConfig", "PoissonMF",
           "PoissonMFConfig"]
