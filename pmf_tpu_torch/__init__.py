"""PyTorch/CUDA port of pmf_tpu: the hybrid HPF-CAVI fit on an NVIDIA H100.

Imports torch only; nothing of JAX or of the JAX package.
"""

from pmf_tpu_torch.models.hpf import HPF, HPFConfig

__all__ = ["HPF", "HPFConfig"]
