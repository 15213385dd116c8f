"""One training step of the port against the reference's, on the ten reduced
architectures (float32 masters, ``cast_bf16=True``, the default
``OptConfig`` with ``warmup_steps=1``), from the same weights carried across
by ``lm_params_from_numpy`` and the same batch. The reference's step is
compiled without excess precision (``test_torch_train_helpers``).

Tolerances: the loss within 1e-5 and the gradient norm within 1e-5
relative; the new moments m and v within 1e-4 of each leaf's largest |m|
or |v|, except at no more than 0.1% of the entries, which may differ by
one bfloat16 ulp of the leaf's largest (m) or two (v): there the two
float32 gradients, equal to float noise, round to neighbouring bfloat16
values (``test_torch_train_rule``).

The new parameters within 1e-6 after the update that each side's own
moments give (``test_torch_train_rule``): AdamW's first step moves an
entry by about lr * sign(g), and where a gradient at float noise differs
the two may part by up to 2 lr; their count is printed."""

import pytest

from test_torch_lm_helpers import NAMES
from test_torch_train_helpers import B, assert_matches_reference


@pytest.mark.parametrize("name", NAMES[:5])  # the other five: test_torch_train_step_more.py
def test_one_step_matches_reference(name):
    assert_matches_reference(name, 1, B)
