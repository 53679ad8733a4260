from pmf_tpu_torch.models.gaussian_mf import GaussianMF, GaussianMFConfig
from pmf_tpu_torch.models.hpf import HPF, HPFConfig
from pmf_tpu_torch.models.hpf_map import HPFMap, HPFMapConfig
from pmf_tpu_torch.models.poisson_mf import PoissonMF, PoissonMFConfig

__all__ = ["GaussianMF", "GaussianMFConfig", "HPF", "HPFConfig", "HPFMap",
           "HPFMapConfig", "PoissonMF", "PoissonMFConfig"]
