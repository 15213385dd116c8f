"""The training port's loss and gradients against the reference, on the ten
reduced architectures in float32, on the reference's own init carried
across by ``lm_params_from_numpy``: ``Model.train_loss`` within 1e-5 of
the reference's, and every gradient leaf, under the port's names, within
1e-4 of the leaf's largest |g| (float32 sums in other orders over a few
layers). Remat is held in ``test_torch_train_remat.py``, the set of leaves
the reference weight-decays and casts in ``test_torch_train_layout.py``."""

import pytest

from test_torch_lm_helpers import NAMES
from test_torch_train_helpers import assert_loss_and_grads_match


@pytest.mark.parametrize("name", NAMES[:5])  # the other five: test_torch_train_models_more.py
def test_train_loss_and_grads_match_reference(name):
    assert_loss_and_grads_match(name)
