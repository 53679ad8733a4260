"""The HPF-MAP fit at K = 160 on the CPU, at a cut of the bench's shape:
``synth`` at 1/128 of its users, items and ratings, 1/128 of its held-out
ratings and of its batch (512), so an epoch keeps the bench's 380 Adam
steps.  At K = 160 the start predicts about 160 softplus(0)^2 = 77 for
ratings of 1..5, and Adam moves a parameter by about lr a step: at the
K = 20 default lr 0.001 three epochs leave the JAX package's val RMSE
above 5; at lr 0.01 it falls every epoch to about 1.48 (1.41 is the best
constant's on these uniform ratings); at 0.02 it rises again in the third
epoch.  The port's fits at lr 0.01, flat and blocked, are held to the
reference's val RMSE history epoch by epoch within 3%: their shuffles
differ (a torch generator against a JAX key) and the blocked engine
composes its batches of tile-band segments, so the trajectories are
compared, not the bits."""

import numpy as np
import pytest
import torch

from pmf_tpu.models import hpf_map as j_map
from pmf_tpu_torch.data.synthetic import synth
from pmf_tpu_torch.models import hpf_map as t_map

torch.set_num_threads(1)

K = 160
LR = 0.01  # the learning rate of chip_smoke.py's phase mhugefit
CUT = 128
EPOCHS = 3
RMSE_RTOL = 0.03  # the port's val RMSE against the reference's, each epoch
CONVERGED = 2.0  # the val RMSE a converging fit ends below after 3 epochs


@pytest.fixture(scope="module")
def cut_bench():
    """The bench's data (``chip_smoke.py``'s phase data) at 1/CUT."""
    n_users, n_items, nnz = 162_000 // CUT, 59_000 // CUT, 25_000_000 // CUT
    u, i, x = synth(n_users, n_items, nnz, seed=0)
    rng = np.random.default_rng(1)
    val = n_users + rng.choice(nnz - n_users, size=100_000 // CUT, replace=False)
    keep = np.ones(nnz, bool)
    keep[val] = False
    return (u[keep], i[keep], x[keep]), (u[~keep], i[~keep], x[~keep])


def _cfg(mod, lr, engine):
    return mod.HPFMapConfig(n_factors=K, lr=lr, batch_size=65536 // CUT, epochs=EPOCHS,
                            verbose=False, engine=engine)


def _reference(cut_bench, lr):
    train, val = cut_bench
    model = j_map.HPFMap(_cfg(j_map, lr, "flat")).fit(train, val)
    return [h["val_rmse"] for h in model.fit_history]


@pytest.fixture(scope="module")
def reference_at_lr(cut_bench):
    return _reference(cut_bench, LR)


def test_reference_converges_at_k160_at_the_chosen_lr(reference_at_lr):
    hist = reference_at_lr
    assert len(hist) == EPOCHS and np.all(np.diff(hist) < 0) and hist[-1] < CONVERGED


@pytest.mark.parametrize("lr", [0.001, 0.02])
def test_reference_at_the_neighbouring_lrs_does_not(cut_bench, lr):
    """lr 0.001 (the K = 20 default) is still far off after 3 epochs; lr
    0.02 overshoots: its val RMSE rises in the last epoch."""
    hist = _reference(cut_bench, lr)
    if lr < LR:
        assert hist[-1] > 2.5 * CONVERGED
    else:
        assert hist[-1] > hist[-2]


@pytest.mark.parametrize("engine", ["flat", "blocked_high"])
def test_port_fit_holds_to_the_reference_at_k160(cut_bench, reference_at_lr, engine):
    train, val = cut_bench
    model = t_map.HPFMap(_cfg(t_map, LR, engine)).fit(train, val, device="cpu")
    assert model.engine_used == engine
    hist = [h["val_rmse"] for h in model.fit_history]
    assert np.all(np.diff(hist) < 0) and hist[-1] < CONVERGED
    np.testing.assert_allclose(hist, reference_at_lr, rtol=RMSE_RTOL)
