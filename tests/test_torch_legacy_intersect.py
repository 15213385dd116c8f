"""``mine_preprocessed(..., intersect_fn=...)``: the older injection contract,
adapted by ``LegacyIntersectPipeline`` (host classification), mined through
``make_sharded_intersect`` on CPU meshes, equal to the reference's mine
(itemsets with counts and per-level stats) on the three random tables of
``tests/test_sharded_driver.py`` (the same generator draws), for
``word_axis`` None and "model", on each mesh shape of the port's mesh tests."""

import numpy as np
import pytest

from repro.core import KyivConfig as RefKyivConfig, mine as ref_mine
from repro_torch.core import KyivConfig, itemize, preprocess
from repro_torch.core.kyiv import mine_preprocessed
from repro_torch.core.sharded import make_sharded_intersect
from repro_torch.kernels.intersect.ops import LegacyIntersectPipeline
from repro_torch.launch.mesh import mesh_from_spec

SPECS = ("1x8", "2x4", "4x2", "8x1")


def _tables():
    """(word_axis, D) in the order ``test_sharded_driver`` draws them."""
    rng = np.random.default_rng(11)
    out = []
    for word_axis in (None, "model"):
        out += [(word_axis, rng.integers(0, 4, size=(80, 6))) for _ in range(3)]
        rng.integers(0, 4, size=(80, 6))  # that test's host-classified baseline table
    return out


def _key(res):
    stats = [(s.k, s.candidates, s.support_pruned, s.bound_pruned, s.intersections, s.emitted,
              s.skipped_absent_uniform, s.stored) for s in res.stats]
    return sorted((tuple(int(i) for i in items), int(c)) for items, c in res.itemsets), stats


@pytest.mark.parametrize("spec", SPECS)
def test_intersect_fn_mine_equals_reference(spec):
    for word_axis, D in _tables():
        want = _key(ref_mine(D, RefKyivConfig(tau=2, kmax=4, engine="numpy")))
        cfg = KyivConfig(tau=2, kmax=4, engine="torch", device="cpu")
        fn = make_sharded_intersect(mesh_from_spec(spec, devices=["cpu"] * 8),
                                    word_axis=word_axis, engine="torch")
        got = mine_preprocessed(preprocess(itemize(D), cfg.tau), cfg, intersect_fn=fn)
        assert _key(got) == want, (spec, word_axis)


def test_pipeline_factory_takes_precedence_over_intersect_fn():
    D = np.random.default_rng(3).integers(0, 4, size=(60, 5))
    cfg = KyivConfig(tau=2, kmax=3, engine="torch", device="cpu")
    prep = preprocess(itemize(D), cfg.tau)
    calls = []

    def fn(bits, pairs, write_children):
        raise AssertionError("intersect_fn must not run under a pipeline_factory")

    def factory(bits, counts, tau):
        calls.append(len(bits))
        return LegacyIntersectPipeline(_plain_intersect, bits)

    got = mine_preprocessed(prep, cfg, intersect_fn=fn, pipeline_factory=factory)
    assert calls
    assert _key(got) == _key(ref_mine(D, RefKyivConfig(tau=2, kmax=3, engine="numpy")))


def _plain_intersect(bits, pairs, write_children):
    child = bits[pairs[:, 0]] & bits[pairs[:, 1]]
    counts = np.unpackbits(child.view(np.uint8), axis=1).sum(axis=1).astype(np.int64)
    return (child if write_children else None), counts
