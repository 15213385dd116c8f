"""The port's word-sharded mesh (``repro_torch.core.sharded``,
``MeshPlacement``, ``launch.mesh``) on a mesh of 8 ``cpu`` entries.

Held, with zero tolerance, against the single-device torch mine and numpy,
and against the reference's ``make_sharded_pipeline`` /
``make_sharded_intersect`` on 8 forced host devices (in a subprocess, as
the reference's own sharded tests run them): itemsets, per-level stat
tuples, ``level_bytes``, class codes, children, coverage accumulators and
risk profiles. Widths not divisible by ``4 x model`` and words with the
sign bit set are in the sweeps."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import KyivConfig, itemize, mine, preprocess
from repro_torch.core.kyiv import mine_preprocessed
from repro_torch.core.placement import DevicePlacement, HostPlacement, MeshPlacement
from repro_torch.core.sharded import (
    MeshBits,
    make_sharded_intersect,
    make_sharded_pipeline,
    shard_width,
    sharded_coverage_step,
)
from repro_torch.kernels.coverage.ops import CoverageEngine
from repro_torch.launch.mesh import make_host_mesh, mesh_for_device, mesh_from_spec

SPECS = ("1x8", "2x4", "4x2", "8x1")
CPU8 = ["cpu"] * 8
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _mesh(spec):
    return mesh_from_spec(spec, devices=CPU8)


def _stats(res):
    return [(s.k, s.candidates, s.support_pruned, s.bound_pruned, s.intersections, s.emitted,
             s.skipped_absent_uniform, s.stored, s.level_bytes) for s in res.stats]


def _key(res):
    return sorted(res.itemsets), _stats(res)


def _data(seed, n=300, m=6, dom=4):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


# ---------------------------------------------------------------------------
# the mesh mine against the single-device torch mine and numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("word_axis", [None, "model"])
def test_mesh_mine_equals_single_device_and_numpy(spec, word_axis):
    mesh = _mesh(spec)
    for seed, (tau, kmax) in enumerate([(2, 4), (1, 3), (5, 4)]):
        D = _data(10 + seed)
        want = _key(mine(D, KyivConfig(tau=tau, kmax=kmax, engine="numpy")))
        assert _key(mine(D, KyivConfig(tau=tau, kmax=kmax, engine="torch", device="cpu"))) == want
        prep = preprocess(itemize(D), tau)
        cfg = KyivConfig(tau=tau, kmax=kmax, engine="torch", device="cpu")
        for fused in (True, False):
            for front in (True, False):
                factory = make_sharded_pipeline(mesh, word_axis=word_axis, engine="torch",
                                                fused_classify=fused, device_frontier=front)
                got = _key(mine_preprocessed(prep, cfg, pipeline_factory=factory))
                assert got == want, (spec, word_axis, seed, fused, front)


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_gathered_family_and_no_bounds(spec):
    D = _data(3, n=260)
    for use_bounds in (True, False):
        cfg = KyivConfig(tau=2, kmax=4, engine="torch", device="cpu", use_bounds=use_bounds,
                         indexed_kernel=False)
        want = _key(mine(D, KyivConfig(tau=2, kmax=4, engine="numpy", use_bounds=use_bounds)))
        factory = make_sharded_pipeline(_mesh(spec), word_axis="model", engine="torch",
                                        indexed=False, device_frontier=True)
        got = _key(mine_preprocessed(preprocess(itemize(D), 2), cfg, pipeline_factory=factory))
        assert got == want


def test_mesh_checkpoints_hold_host_bits():
    D = _data(5)
    cfg = KyivConfig(tau=2, kmax=4, engine="torch", device="cpu")
    prep = preprocess(itemize(D), 2)
    saved = {}, {}
    for store, factory in zip(saved, (None, make_sharded_pipeline(
            _mesh("2x4"), word_axis="model", engine="torch", device_frontier=True))):
        mine_preprocessed(prep, cfg, pipeline_factory=factory,
                          on_level_end=lambda k, st, _s=store: _s.__setitem__(k, st))
    assert saved[0].keys() == saved[1].keys() and saved[0]
    for k in saved[0]:
        a, b = saved[0][k].level, saved[1][k].level
        assert b.bits.dtype == np.uint32
        np.testing.assert_array_equal(a.bits, b.bits)
        np.testing.assert_array_equal(a.itemsets, b.itemsets)


# ---------------------------------------------------------------------------
# dispatch: widths, sign-bit words, class codes, children
# ---------------------------------------------------------------------------


def _bits(rng, t, w):
    bits = rng.integers(0, 2**32, size=(t, w), dtype=np.uint32)
    bits[rng.random((t, w)) < 0.2] = 0xFFFFFFFF  # sign bit set
    bits[rng.random((t, w)) < 0.2] = 0
    return bits


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("w", [1, 5, 9, 13, 33])
def test_mesh_dispatch_equals_host(spec, w):
    rng = np.random.default_rng(w)
    t = 23
    bits = _bits(rng, t, w)
    pc = np.bitwise_count(bits).sum(axis=1).astype(np.int64)
    host = HostPlacement()
    mesh = MeshPlacement(_mesh(spec), word_axis="model", engine="torch")
    assert shard_width(w, mesh.word_shards) % 4 == 0
    m = 37
    pairs = np.zeros((mesh.padded_size(m), 2), dtype=np.int32)
    pairs[:m] = rng.integers(0, t, size=(m, 2))
    tau = int(np.median(pc))
    for fused in (True, False):
        for write in (True, False):
            hs = host.prepare(bits, pc, tau, fused_classify=fused)
            ms = mesh.prepare(bits, pc, tau, fused_classify=fused)
            hc, hn, hk = host.dispatch(hs, pairs, write)
            mc, mn, mk = mesh.dispatch(ms, pairs, write)
            np.testing.assert_array_equal(mn.numpy(), hn)
            if fused:
                np.testing.assert_array_equal(mk.numpy(), hk)
                # padding self-pairs classify as SKIP
                assert (mk.numpy()[m:] == 0).all()
            else:
                assert mk is None
            if write:
                np.testing.assert_array_equal(mc[:m].host_words(), hc[:m])
                rows = np.array([m - 1, 0, 5, m // 2, 3])
                np.testing.assert_array_equal(mesh.take_rows(mc, rows).host_words(), hc[rows])
            mesh.release(ms)


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_launches_once_per_shard_and_batch(spec, monkeypatch):
    import repro_torch.core.sharded as sh

    sums = []
    real_sum = sh._sum_to
    monkeypatch.setattr(sh, "_sum_to", lambda parts, dev: sums.append(len(parts)) or
                        real_sum(parts, dev))
    mesh = MeshPlacement(_mesh(spec), word_axis="model", engine="torch")
    bits = _bits(np.random.default_rng(0), 10, 7)
    st = mesh.prepare(bits, np.ones(10), 3, fused_classify=True)
    pairs = np.zeros((mesh.padded_size(4), 2), dtype=np.int32)
    mesh.dispatch(st, pairs, True)
    mesh.dispatch(st, pairs, False)
    d, w = mesh.pair_shards, mesh.word_shards
    assert sum(mesh.shard_launches.values()) == 2 * d * w
    assert set(mesh.shard_launches) == {("dispatch", i, j) for i in range(d) for j in range(w)}
    # one cross-shard sum of the word shards' partials per pair shard and
    # batch; none with one word shard (the fused kernels classify whole counts)
    assert sums == ([w] * (2 * d) if w > 1 else [])


# ---------------------------------------------------------------------------
# coverage and risk on the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_sharded_coverage_step_equals_coverage_engine(spec):
    rng = np.random.default_rng(7)
    bits = _bits(rng, 30, 11)
    sets = rng.integers(0, 30, size=(64, 3)).astype(np.int32)
    weights = rng.integers(-3, 9, size=64).astype(np.int32)
    want = CoverageEngine(bits, placement=HostPlacement(), set_width=3).accumulate(sets, weights)
    dev = CoverageEngine(bits, placement=DevicePlacement("torch", device="cpu"), set_width=3)
    np.testing.assert_array_equal(dev.accumulate(sets, weights), want)
    placement = MeshPlacement(_mesh(spec), word_axis="model", engine="torch")
    got = CoverageEngine(bits, placement=placement, set_width=3).accumulate(sets, weights)
    np.testing.assert_array_equal(got, want)
    # the step itself, over an explicitly placed batch
    grid, indexes = placement.prepare_coverage(bits)
    step = sharded_coverage_step(placement.mesh, engine="torch")
    n = placement.padded_size(64)
    ps, pw = np.zeros((n, 3), np.int32), np.zeros(n, np.int32)
    ps[:64], pw[:64] = sets, weights
    acc = step(grid, indexes, ps, pw).numpy()
    np.testing.assert_array_equal(acc[:, :11].astype(np.int64), want)


@pytest.mark.parametrize("spec", ["2x4", "8x1"])
def test_mesh_risk_profile_equals_host(spec):
    from repro_torch.privacy.risk import risk_profile

    D = _data(9, n=400)
    res = mine(D, KyivConfig(tau=2, kmax=3, engine="numpy"))
    want = risk_profile(res, placement=HostPlacement())
    got = risk_profile(res, placement=MeshPlacement(_mesh(spec), word_axis="model",
                                                    engine="torch"))
    np.testing.assert_array_equal(got.counts_by_size, want.counts_by_size)
    np.testing.assert_array_equal(got.risk, want.risk)


# ---------------------------------------------------------------------------
# the resident service on a mesh
# ---------------------------------------------------------------------------


def test_mining_service_on_a_mesh_equals_plain_service():
    from repro_torch.service import MiningService

    base, delta = _data(21, n=500, m=5), _data(22, n=40, m=5)
    mesh = MiningService(placement=MeshPlacement(_mesh("2x4"),
                                                 word_axis="model", engine="torch"))
    plain = MiningService(engine="numpy")
    for svc in (mesh, plain):
        svc.append(base)
    a, b = mesh.mine(tau=2, kmax=4), plain.mine(tau=2, kmax=4)
    assert a.source == b.source == "cold" and a.result.itemsets == b.result.itemsets
    for svc in (mesh, plain):
        svc.append(delta)
    a, b = mesh.mine(tau=2, kmax=4), plain.mine(tau=2, kmax=4)
    assert a.source == b.source == "incremental"
    assert sorted(a.result.itemsets) == sorted(b.result.itemsets)
    ra, rb = mesh.risk(tau=2, kmax=4), plain.risk(tau=2, kmax=4)
    for k in ("records_at_risk", "max_risk", "qi_total", "top_records"):
        assert ra[k] == rb[k]
    desc = mesh.stats()["placement"]
    assert desc["kind"] == "mesh" and desc["distinct_devices"] == ["cpu"]
    assert desc["mesh_entries"] == ["cpu"] * 8
    mesh.close()
    plain.close()


# ---------------------------------------------------------------------------
# mesh specs
# ---------------------------------------------------------------------------


def test_mesh_specs():
    assert mesh_from_spec("8", devices=CPU8).shape == {"data": 1, "model": 8}
    assert mesh_from_spec("4×2", devices=CPU8).shape == {"data": 4, "model": 2}
    for bad in ("4x", "0x2", "axb", "1x2x2x2"):
        with pytest.raises(ValueError, match="spec"):
            mesh_from_spec(bad, devices=CPU8)
    with pytest.raises(ValueError, match="needs 8 device entries"):
        mesh_from_spec("2x4", devices=["cpu"] * 3)
    # a three-part spec maps its first part onto the fleet's processes
    assert mesh_from_spec("2x2x2", devices=["cpu"] * 4, num_processes=2).shape == {
        "data": 2, "model": 2}
    with pytest.raises(ValueError, match="never spans processes"):
        mesh_from_spec("2x2x2", devices=["cpu"] * 4)
    assert make_host_mesh(devices=["cpu"] * 3).shape == {"data": 1, "model": 2}
    assert make_host_mesh(devices=["cpu"]).shape == {"data": 1, "model": 1}
    assert mesh_for_device("2x2", "cpu").shape == {"data": 2, "model": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cards"):
            mesh_from_spec("2x2")


def test_launch_plumbing():
    from repro_torch.launch.mesh import distributed_init, is_main, launch_env_summary

    assert distributed_init(None, 1, 0) == (0, 1) and is_main()
    with pytest.raises(ValueError, match="coordinator-address"):
        distributed_init(None, 2, 0)
    with pytest.raises(ValueError, match="process-id"):
        distributed_init("127.0.0.1:1", 2, 2)
    env = launch_env_summary()
    assert env["process_count"] == 1 and env["torch"] == torch.__version__
    assert {"ld_preload", "pytorch_cuda_alloc_conf", "tcmalloc_report_threshold"} <= set(env)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_args", [["--sharded"], ["--sharded", "--mesh", "2x4"],
                                       ["--mesh", "4x2", "--no-fused-classify"]])
def test_cli_sharded_equals_unsharded(tmp_path, capsys, mesh_args):
    from repro_torch.launch.mine import main

    common = ["--engine", "torch", "--device", "cpu", "--n", "400", "--m", "6", "--kmax", "3",
              "--tau", "2"]
    main(common + mesh_args + ["--out", str(tmp_path / "a.json")])
    assert "sharded over mesh" in capsys.readouterr().out
    main(common + ["--out", str(tmp_path / "b.json")])
    a, b = (json.loads((tmp_path / f).read_text()) for f in ("a.json", "b.json"))
    assert a["itemsets"] == b["itemsets"]
    cols = ("k", "candidates", "support_pruned", "bound_pruned", "intersections", "emitted",
            "skipped_absent_uniform", "stored", "level_bytes")
    assert [[s[c] for c in cols] for s in a["stats"]] == [[s[c] for c in cols] for s in b["stats"]]


# ---------------------------------------------------------------------------
# against the reference's mesh on 8 forced host devices
# ---------------------------------------------------------------------------

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax
from repro.core import KyivConfig, itemize, preprocess
from repro.core.kyiv import mine_preprocessed
from repro.core.sharded import make_sharded_intersect, make_sharded_pipeline

out = {"mine": {}, "intersect": {}}
for spec in ("1x8", "2x4", "4x2", "8x1"):
    d, m = map(int, spec.split("x"))
    mesh = jax.make_mesh((d, m), ("data", "model"))
    for seed, tau, kmax in ((31, 2, 4), (32, 1, 3)):
        D = np.random.default_rng(seed).integers(0, 4, size=(300, 6))
        prep = preprocess(itemize(D), tau)
        for wa in ("none", "model"):
            for fused in (True, False):
                f = make_sharded_pipeline(mesh, word_axis=None if wa == "none" else wa,
                                          fused_classify=fused)
                r = mine_preprocessed(prep, KyivConfig(tau=tau, kmax=kmax), pipeline_factory=f)
                out["mine"][f"{spec}/{seed}/{wa}/{fused}"] = {
                    "itemsets": sorted([[list(map(int, i)), int(c)] for i, c in r.itemsets]),
                    "stats": [[s.k, s.candidates, s.support_pruned, s.bound_pruned,
                               s.intersections, s.emitted, s.skipped_absent_uniform, s.stored,
                               s.level_bytes] for s in r.stats]}
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2**32, size=(19, 13), dtype=np.uint32)
    bits[rng.random(bits.shape) < 0.3] = 0xFFFFFFFF
    pairs = rng.integers(0, 19, size=(29, 2)).astype(np.int32)
    for wa in ("none", "model"):
        fn = make_sharded_intersect(mesh, word_axis=None if wa == "none" else wa)
        child, counts = fn(bits, pairs, True)
        out["intersect"][f"{spec}/{wa}"] = {"child": np.asarray(child).tolist(),
                                            "counts": np.asarray(counts).tolist()}
print("REF" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_mesh():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REF, SRC], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("REF"))
    return json.loads(line[3:])


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_equals_reference_make_sharded_pipeline(reference_mesh, spec):
    mesh = _mesh(spec)
    for seed, tau, kmax in ((31, 2, 4), (32, 1, 3)):
        D = np.random.default_rng(seed).integers(0, 4, size=(300, 6))
        prep = preprocess(itemize(D), tau)
        cfg = KyivConfig(tau=tau, kmax=kmax, engine="torch", device="cpu")
        for wa in ("none", "model"):
            for fused in (True, False):
                # the reference runs its host frontier on a CPU mesh; so does
                # the port's CPU mesh by default
                f = make_sharded_pipeline(mesh, word_axis=None if wa == "none" else wa,
                                          engine="torch", fused_classify=fused)
                assert f.placement.use_device_frontier is False
                r = mine_preprocessed(prep, cfg, pipeline_factory=f)
                want = reference_mesh["mine"][f"{spec}/{seed}/{wa}/{fused}"]
                assert sorted([[list(map(int, i)), int(c)] for i, c in r.itemsets]) == \
                    want["itemsets"]
                assert [list(s) for s in _stats(r)] == want["stats"]


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_equals_reference_make_sharded_intersect(reference_mesh, spec):
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2**32, size=(19, 13), dtype=np.uint32)
    bits[rng.random(bits.shape) < 0.3] = 0xFFFFFFFF
    pairs = rng.integers(0, 19, size=(29, 2)).astype(np.int32)
    for wa in ("none", "model"):
        fn = make_sharded_intersect(_mesh(spec), word_axis=None if wa == "none" else wa,
                                    engine="torch")
        child, counts = fn(bits, pairs, True)
        want = reference_mesh["intersect"][f"{spec}/{wa}"]
        assert child.dtype == np.uint32 and child.shape == (29, 13)
        assert child.tolist() == want["child"] and counts.tolist() == want["counts"]


def test_mesh_bits_host_view_strips_shard_padding():
    bits = _bits(np.random.default_rng(1), 6, 9)
    mb = MeshPlacement(_mesh("2x4"), word_axis="model", engine="torch").put_bits(bits)
    assert isinstance(mb, MeshBits) and mb.shape == (6, 9)
    assert all(p.shape[1] == shard_width(9, 4) == 4 for p in mb.parts)
    np.testing.assert_array_equal(mb.host_words(), bits)
    np.testing.assert_array_equal(mb[[4, 1]].host_words(), bits[[4, 1]])


def test_serve_miner_on_a_mesh(tmp_path):
    """``serve_miner --mesh 2x2`` on a mesh of ``cpu`` entries answers as a
    plain service."""
    import signal
    import socket
    import time
    import urllib.request

    from repro_torch.data.synth import randomized_dataset
    from repro_torch.service import MiningService

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_miner", "--engine", "torch",
         "--device", "cpu", "--mesh", "2x2", "--port", str(port), "--preload", "randomized",
         "--n", "600", "--m", "6"],
        env=dict(os.environ, PYTHONPATH=SRC), stderr=subprocess.DEVNULL)

    def get(path):
        return json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                                 timeout=60).read())

    try:
        deadline = time.time() + 60
        while True:
            try:
                get("/healthz")
                break
            except OSError:
                assert time.time() < deadline and proc.poll() is None
                time.sleep(0.2)
        got = get("/mine?tau=1&kmax=3")
        desc = get("/stats")["placement"]
        plain = MiningService.from_dataset(randomized_dataset(600, 6, seed=0), engine="numpy")
        want = plain.mine(tau=1, kmax=3).to_json()
        plain.close()
        assert got["source"] == "cold" and got["itemsets"] == want["itemsets"]
        assert desc["kind"] == "mesh" and desc["mesh_shape"] == {"data": 2, "model": 2}
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
