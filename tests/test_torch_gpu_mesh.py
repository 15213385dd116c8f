"""The word-sharded mesh on a card: a mesh whose entries all repeat
``cuda:0`` (one tensor and one launch per entry) mines as the single-device
CUDA mine and the numpy engine, launching the unfused kernels (rows 3-4)
once per word shard and batch, or the fused ones (rows 1-2) with one word
shard; the mesh's coverage dispatch and its service equal the card's.
Marked ``gpu``; every test skips where torch sees no CUDA card (run them
there with ``python -m pytest -m gpu tests/test_torch_gpu_mesh.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.core import KyivConfig, itemize, mine, preprocess
from repro_torch.core.kyiv import mine_preprocessed
from repro_torch.core.placement import HostPlacement, MeshPlacement
from repro_torch.core.sharded import make_sharded_pipeline
from repro_torch.kernels import coverage, intersect
from repro_torch.launch.mesh import mesh_from_spec

pytestmark = pytest.mark.gpu

UNFUSED = ("intersect_write_indexed", "intersect_count_indexed")
FUSED = ("intersect_classify_write_indexed", "intersect_classify_count_indexed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _key(res):
    return sorted(res.itemsets), [(s.k, s.candidates, s.support_pruned, s.bound_pruned,
                                   s.intersections, s.emitted, s.skipped_absent_uniform,
                                   s.stored, s.level_bytes) for s in res.stats]


def _data(seed, n=20_000, m=8, dom=9):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


@pytest.mark.parametrize("spec", ["2x2", "1x4", "4x1", "2x1"])
@pytest.mark.parametrize("front", [True, False])
def test_repeated_card_mesh_equals_single_device(cuda, spec, front):
    D = _data(0)
    cfg = KyivConfig(tau=1, kmax=4, engine="cuda", device="cuda:0")
    want = mine(D, cfg)
    assert _key(want) == _key(mine(D, KyivConfig(tau=1, kmax=4, engine="numpy")))
    d, w = map(int, spec.split("x"))
    mesh = mesh_from_spec(spec, devices=[cuda] * (d * w))
    factory = make_sharded_pipeline(mesh, word_axis="model", engine="cuda", device_frontier=front)
    intersect.reset_launches()
    got = mine_preprocessed(preprocess(itemize(D), 1), cfg, pipeline_factory=factory)
    assert _key(got) == _key(want)
    launches = {k: v for k, v in intersect.LAUNCHES.items() if v}
    rows = FUSED if w == 1 else UNFUSED
    assert set(launches) == set(rows)
    per_shard = {k: n for k, n in factory.placement.shard_launches.items() if k[0] == "dispatch"}
    assert set(per_shard) == {("dispatch", i, j) for i in range(d) for j in range(w)}
    assert len(set(per_shard.values())) == 1  # every entry launches once per batch
    assert sum(launches.values()) == sum(per_shard.values())


def test_mesh_coverage_and_risk_on_the_card(cuda):
    from repro_torch.privacy import risk_profile

    res = mine(_data(1, n=3_000, dom=12), KyivConfig(tau=1, kmax=3, engine="cuda",
                                                     device="cuda:0"))
    assert res.itemsets
    want = risk_profile(res, placement=HostPlacement())
    placement = MeshPlacement(mesh_from_spec("2x2", devices=[cuda] * 4), word_axis="model",
                              engine="cuda")
    coverage.reset_launches()
    got = risk_profile(res, placement=placement)
    np.testing.assert_array_equal(got.counts_by_size, want.counts_by_size)
    np.testing.assert_array_equal(got.risk, want.risk)
    launched = sum(coverage.LAUNCHES.values())
    assert launched and launched == sum(
        n for k, n in placement.shard_launches.items() if k[0] == "coverage")


def test_mesh_service_on_the_card(cuda):
    from repro_torch.service import MiningService

    base, delta = _data(2, n=8_000, m=6), _data(3, n=300, m=6)
    svc = MiningService(placement=MeshPlacement(mesh_from_spec("2x2", devices=[cuda] * 4),
                                                word_axis="model", engine="cuda"))
    plain = MiningService(engine="numpy")
    for s in (svc, plain):
        s.append(base)
    assert svc.mine(tau=1, kmax=3).result.itemsets == plain.mine(tau=1, kmax=3).result.itemsets
    for s in (svc, plain):
        s.append(delta)
    a, b = svc.mine(tau=1, kmax=3), plain.mine(tau=1, kmax=3)
    assert a.source == "incremental" and sorted(a.result.itemsets) == sorted(b.result.itemsets)
    assert svc.stats()["placement"]["distinct_devices"] == ["cuda:0"]
    svc.close()
    plain.close()
