"""``utils/platform.py``: ``device_sync`` reads the first element of the
first leaf of a tensor tree, as the JAX package's does of a pytree;
``measure_transfer_rtt`` times a scalar round trip and defaults to the
card."""

import math

import numpy as np
import pytest
import torch

from pmf_tpu_torch.utils import platform

torch.set_num_threads(1)


def test_device_sync_reads_the_first_element_of_the_first_leaf():
    tree = {"a": torch.tensor([[3.5, 1.0], [2.0, 4.0]]), "b": torch.zeros(3)}
    assert platform.device_sync(tree) == 3.5
    assert platform.device_sync([torch.tensor([7.0]), tree]) == 7.0
    assert platform.device_sync(torch.tensor(2.25)) == 2.25
    assert platform.device_sync({}) == 0.0


def test_device_sync_equals_the_jax_one():
    import jax.numpy as jnp

    from pmf_tpu.utils.platform import device_sync as jax_device_sync

    a = np.random.default_rng(0).standard_normal((4, 3))
    got = platform.device_sync({"a": torch.from_numpy(a), "b": torch.ones(2)})
    assert got == jax_device_sync({"a": jnp.asarray(a), "b": jnp.ones(2)})


def test_measure_transfer_rtt_on_the_cpu():
    rtt = platform.measure_transfer_rtt(n=3, device="cpu")
    assert math.isfinite(rtt) and rtt >= 0


def test_measure_transfer_rtt_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform.measure_transfer_rtt()
