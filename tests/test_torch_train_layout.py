"""The set of leaves the reference weight-decays and casts to bfloat16 in a
train step: rank 2 or more in its stacked layout, which puts every grouped
layer's per-layer vectors in the set. The port's
``convert.reference_rank2_names`` is held to the reference's abstract init
(``jax.eval_shape``) for the ten full and the ten reduced configs."""

import jax
import numpy as np
import pytest

from repro.configs import ARCHS, reduced
from repro.models.zoo import build as ref_build
from repro_torch.configs import ARCHS as PORT_ARCHS, reduced as port_reduced
from repro_torch.convert import lm_params_from_numpy, reference_rank2_names
from repro_torch.models.zoo import build as port_build
from test_torch_lm_helpers import NAMES


def _reference_rank2(ref_cfg, port_cfg) -> frozenset:
    """The port names whose reference leaf has rank >= 2, from the reference's
    abstract init: each leaf becomes a small array that holds its rank along
    its first axis, which ``lm_params_from_numpy`` unstacks like any leaf."""
    shapes = jax.eval_shape(lambda: ref_build(ref_cfg).init(jax.random.PRNGKey(0)))
    ranks = jax.tree.map(
        lambda a: np.full(a.shape[:1], a.ndim, np.float32) if a.ndim else np.float32(0), shapes)
    state = lm_params_from_numpy(ranks, port_cfg)
    return frozenset(n for n, t in state.items() if float(t.reshape(-1)[0]) >= 2)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_rank2_names_match_reference_layout(name, size):
    rcfg, pcfg = ARCHS[name], PORT_ARCHS[name]
    if size == "reduced":
        rcfg, pcfg = reduced(rcfg), port_reduced(pcfg)
    got = reference_rank2_names(pcfg)
    want = _reference_rank2(rcfg, pcfg)
    assert got == want, sorted(got ^ want)[:10]
    # the port stores per-layer vectors: its own rank would miss the grouped ones
    net = port_build(pcfg).abstract_params()
    own = frozenset(n for n, p in net.named_parameters() if p.dim() >= 2)
    assert own <= got


def test_rank2_names_granite_full_leaves_only_final_norm_out():
    """At full width granite-moe-1b-a400m is one scanned group of 24 layers:
    every leaf but ``final_norm`` has reference rank >= 2."""
    cfg = PORT_ARCHS["granite-moe-1b-a400m"]
    names = {n for n, _ in port_build(cfg).abstract_params().named_parameters()}
    assert names - reference_rank2_names(cfg) == {"final_norm"}
