"""The loss and gradient parity of ``test_torch_train_models.py`` (its
docstring states the tolerances) for the other five reduced architectures,
in a file of its own so that each file stays under a minute on one test
worker."""

import pytest

from test_torch_lm_helpers import NAMES
from test_torch_train_helpers import assert_loss_and_grads_match


@pytest.mark.parametrize("name", NAMES[5:])
def test_train_loss_and_grads_match_reference(name):
    assert_loss_and_grads_match(name)
