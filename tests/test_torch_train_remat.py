"""Remat on and off on the CPU: a checkpoint recomputes the same ops on the
same inputs, so the loss and every gradient of the ten reduced
architectures are bit for bit those without remat."""

import pytest
import torch

from test_torch_lm_helpers import NAMES, pair
from test_torch_train_helpers import B, S, port_grads, train_batches


@pytest.mark.parametrize("name", NAMES)
def test_remat_gives_bit_identical_gradients(name):
    _, _, tm, net = pair(name)
    _, tb = train_batches(tm.cfg, 6, B, S)
    loss_r, g_r = port_grads(tm, net, tb, remat=True)
    loss_n, g_n = port_grads(tm, net, tb, remat=False)
    assert loss_r == loss_n
    for n in g_n:
        assert torch.equal(g_r[n], g_n[n]), n
