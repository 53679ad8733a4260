"""PyTorch/CUDA port of pmf_tpu on an NVIDIA H100: the hybrid HPF-CAVI,
Gaussian-MF CAVI and Poisson-MF CAVI (plain and extended) fits, and
HPF-MAP training by SGD (flat and blocked engines); checkpoints and
resume (``utils.checkpoint``), top-k serving (``FactorModel.recommend``,
``cli.recommend``) and ranking metrics (``eval.ranking``); the
experiment surface: multi-seed fits (``tune.multi_seed``), the CLIs in
``cli`` (run_single, tune, best_k, compare, train_full, reproduce), the
data pipeline (``data.pipeline``, ``utils.mapping``) and the analysis
tools in ``analysis``.

Imports torch only; nothing of JAX or of the JAX package.
"""

from pmf_tpu_torch.models.gaussian_mf import GaussianMF, GaussianMFConfig
from pmf_tpu_torch.models.hpf import HPF, HPFConfig
from pmf_tpu_torch.models.hpf_map import HPFMap, HPFMapConfig
from pmf_tpu_torch.models.poisson_mf import PoissonMF, PoissonMFConfig

__all__ = ["GaussianMF", "GaussianMFConfig", "HPF", "HPFConfig", "HPFMap",
           "HPFMapConfig", "PoissonMF", "PoissonMFConfig"]
