"""The one-step parity of ``test_torch_train_step.py`` (its docstring states
the tolerances) for the other five reduced architectures, in a file of its
own so that each file stays under a minute on one test worker."""

import pytest

from test_torch_lm_helpers import NAMES
from test_torch_train_helpers import B, assert_matches_reference


@pytest.mark.parametrize("name", NAMES[5:])
def test_one_step_matches_reference(name):
    assert_matches_reference(name, 1, B)
