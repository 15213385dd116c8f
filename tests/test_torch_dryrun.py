"""The port's dry run (``repro_torch.launch.dryrun``) and production mesh
(``launch.mesh.make_production_mesh``) on the CPU.

* ``make_plan(make_production_mesh(devices=["meta"] * n))`` gives the
  reference's specs and fallbacks, leaf for leaf, on 16x16 and 2x16x16 for
  the ten full configs (train and serve mode), and the mesh has the
  reference's shape and axes. The reference runs in one subprocess on 512
  forced host devices (``Auto`` axes for its plan).
* ``memory.argument_bytes`` of a train cell, the busiest entry's resident
  bytes under the port's plan, against the reference's
  ``memory_analysis().argument_size_in_bytes`` for the same cell (reduced
  glm4-9b and granite-moe-1b-a400m, B = 8, S = 16, on 2x2 and 4x2). The one
  difference, named by leaf: the port's tokens and labels are int64
  (``launch.train.synthetic_lm_batches``), the reference's int32.
* The whole dry run into a temporary directory, as ``tests/test_artifacts.py``
  holds the reference's records: 66 ok and 14 skipped LM records and 6
  mining records, three non-negative terms each, ``t_compute > 0`` for train
  and prefill, named memory terms that add up to ``peak_estimate_bytes``,
  ``fits`` equal to the peak against ``H100.hbm_bytes``, and the set of
  cells that do not fit under the port's plan step pinned.
* The trace that gives a step's activations (``_LiveBytes``) counts what it
  should, on a hand-sized example; and traced at two depths and extended
  per layer (``_extrapolated``), it gives the bytes of a trace at the whole
  depth, to the byte, for the train step (one row, and rows that split the
  batch), a decode step and a prefill, on each reduced config deepened to
  four periods of its layer pattern.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, ShapeConfig, cells, reduced
from repro_torch.distributed.sharding import make_plan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, mesh_from_spec
from repro_torch.models.zoo import build
from repro_torch.roofline.hw import H100
from test_torch_dist_helpers import norm_spec, run_reference
from test_torch_dist_plan import _REF as PLAN_REF, _ref_leaf_ids

MESHES = {"16x16": (False, (16, 16), ("data", "model")),
          "2x16x16": (True, (2, 16, 16), ("pod", "data", "model"))}
ARG_ARCHS = ("glm4-9b", "granite-moe-1b-a400m")
ARG_MESHES = ("2x2", "4x2")
ARG_B, ARG_S = 8, 16

_REF = PLAN_REF.split("\nfor shape in SHAPES:")[0] + r"""
import jax.numpy as jnp
from repro.configs import reduced
from repro.launch.mesh import make_production_mesh
from repro.training.optimizer import OptConfig, adamw_init
from repro.training.train import make_train_step

for label, (multi, shape, names) in MESHES.items():
    mesh = auto_mesh(shape, names)
    for name in sorted(ARCHS):
        aparams = build(ARCHS[name]).abstract_params()
        for serve in (False, True):
            plan = make_plan(mesh, serve=serve)
            ids, table = id_tree(aparams, plan.param_shardings)
            OUT[(name, label, serve)] = {"ids": ids, "specs": table,
                                         "fallbacks": sorted(plan.fallbacks)}
    m = make_production_mesh(multi_pod=multi)
    OUT[("mesh", label)] = (tuple(m.devices.shape), tuple(m.axis_names))
for spec in ARG_MESHES:
    d, m = map(int, spec.split("x"))
    mesh = auto_mesh((d, m), ("data", "model"))
    for name in ARG_ARCHS:
        model = build(reduced(ARCHS[name]))
        plan = make_plan(mesh)
        step_fn, shardings_for = make_train_step(model, OptConfig(), plan)
        aparams = model.abstract_params()
        pspec, ospec = shardings_for(aparams)
        batch = {k: jax.ShapeDtypeStruct((ARG_B, ARG_S), jnp.int32) for k in ("tokens", "labels")}
        bspec = plan.batch_shardings(batch)
        with jax.set_mesh(mesh):
            compiled = jax.jit(step_fn, in_shardings=(pspec, ospec, bspec),
                               out_shardings=(pspec, ospec, None)).lower(
                aparams, jax.eval_shape(adamw_init, aparams), batch).compile()
        OUT[("args", name, spec)] = int(compiled.memory_analysis().argument_size_in_bytes)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = (f"MESHES = {MESHES!r}\nARG_ARCHS = {ARG_ARCHS!r}\nARG_MESHES = {ARG_MESHES!r}\n"
            f"ARG_B, ARG_S = {ARG_B}, {ARG_S}\n")
    return run_reference(body + _REF, tmp_path_factory.mktemp("ref_dryrun"), n_devices=512,
                         timeout=600)


def _production(label: str):
    multi, shape, _ = MESHES[label]
    return make_production_mesh(multi_pod=multi, devices=["meta"] * int(np.prod(shape)))


@pytest.mark.parametrize("label", sorted(MESHES))
def test_production_mesh_matches_reference(reference, label):
    mesh = _production(label)
    _, shape, names = MESHES[label]
    assert reference[("mesh", label)] == (shape, names)
    assert tuple(mesh.devices.shape) == shape and mesh.axis_names == names
    assert all(d.type == "meta" for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="device entries"):
        make_production_mesh(multi_pod=MESHES[label][0], devices=["meta"] * 4)


@pytest.mark.parametrize("label", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_production_plan_matches_reference(reference, name, label):
    cfg = ARCHS[name]
    net = build(cfg).abstract_params()
    for serve in (False, True):
        plan = make_plan(_production(label), serve=serve)
        got = plan.param_shardings(net)
        rec = reference[(name, label, serve)]
        ids = _ref_leaf_ids(rec["ids"], cfg)
        assert sorted(ids) == sorted(got)
        for n, spec in got.items():
            assert norm_spec(spec) == norm_spec(rec["specs"][ids[n]]), (serve, n, spec)
        assert sorted(set(plan.fallbacks)) == sorted(set(rec["fallbacks"])), serve


@pytest.mark.parametrize("spec", ARG_MESHES)
@pytest.mark.parametrize("name", ARG_ARCHS)
def test_argument_bytes_match_reference(reference, name, spec):
    d, m = map(int, spec.split("x"))
    mesh = mesh_from_spec(spec, devices=["meta"] * (d * m))
    rec = dryrun.lower_cell(reduced(ARCHS[name]), ShapeConfig("t", ARG_S, ARG_B, "train"),
                            mesh=mesh)
    got = rec["memory"]["argument_bytes"]
    # tokens and labels: int64 in the port's batches, int32 in the reference's
    int64_tokens = 2 * (ARG_B // d) * ARG_S * (8 - 4)
    assert got - int64_tokens == reference[("args", name, spec)], (got, int64_tokens)
    assert rec["compute_entries"] == d and rec["entries"] == d * m


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    dryrun.main(["--mesh", "both", "--out", str(out)])
    dryrun.main(["--mining", "--out", str(out)])
    return [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]


NOT_FITTING = {
    ("deepseek-v2-lite-16b", "train_4k", "pod16x16"),
    ("deepseek-v2-lite-16b", "train_4k", "pod2x16x16"),
    ("gemma3-4b", "train_4k", "pod16x16"),
    ("glm4-9b", "train_4k", "pod16x16"),
    ("glm4-9b", "train_4k", "pod2x16x16"),
    ("internvl2-26b", "decode_32k", "pod16x16"),
    ("internvl2-26b", "train_4k", "pod16x16"),
    ("internvl2-26b", "train_4k", "pod2x16x16"),
    ("nemotron-4-15b", "train_4k", "pod16x16"),
    ("nemotron-4-15b", "train_4k", "pod2x16x16"),
    ("qwen1.5-110b", "decode_32k", "pod16x16"),
    ("qwen1.5-110b", "decode_32k", "pod2x16x16"),
    ("qwen1.5-110b", "prefill_32k", "pod16x16"),
    ("qwen1.5-110b", "prefill_32k", "pod2x16x16"),
    ("qwen1.5-110b", "train_4k", "pod16x16"),
    ("qwen1.5-110b", "train_4k", "pod2x16x16"),
    ("recurrentgemma-9b", "train_4k", "pod16x16"),
    ("recurrentgemma-9b", "train_4k", "pod2x16x16"),
    ("whisper-medium", "train_4k", "pod16x16"),
}


def test_dryrun_records_complete(records):
    by_key = {(r["arch"], r["shape"], r["mesh"]): r for r in records if r.get("kind") != "mining"}
    n_ok = n_skip = 0
    for arch, shape, skipped in cells(include_skipped=True):
        for mesh in ("pod16x16", "pod2x16x16"):
            r = by_key[(arch.name, shape.name, mesh)]
            if skipped:
                assert r["status"] == "skipped" and shape.name == "long_500k"
                n_skip += 1
            else:
                assert r["status"] == "ok", r.get("error")
                n_ok += 1
    assert (n_ok, n_skip) == (66, 14)
    mining = [r for r in records if r.get("kind") == "mining"]
    assert sorted((r["arch"], r["mesh"]) for r in mining) == sorted(
        (a, m) for a in ("kyiv-mining-count", "kyiv-mining-count-tiled", "kyiv-mining-write")
        for m in ("pod16x16", "pod2x16x16"))


def test_dryrun_terms_present_and_sane(records):
    for r in records:
        if r["status"] != "ok":
            continue
        rl = r["roofline"]
        for term in ("t_compute", "t_memory", "t_collective"):
            assert term in rl and rl[term] >= 0 and math.isfinite(rl[term]), (r["arch"], term)
        assert rl["dominant"] in ("compute", "memory", "collective")
        if r["kind"] in ("train", "prefill"):
            assert rl["t_compute"] > 0
        if r["kind"] == "mining":
            assert rl["t_compute"] > 0 and rl["t_memory"] > 0
            continue
        mem = r["memory"]
        assert mem["peak_estimate_bytes"] == sum(mem["detail"].values())
        assert mem["detail"]["argument"] == mem["argument_bytes"] > 0
        assert all(v >= 0 for v in mem["detail"].values()), mem["detail"]
        assert mem["fits"] == (mem["peak_estimate_bytes"] < H100.hbm_bytes)
        assert rl["step_time"] == max(rl["t_compute"], rl["t_memory"], rl["t_collective"])
        entries = 512 if r["mesh"] == "pod2x16x16" else 256
        assert r["entries"] == entries and 1 <= r["compute_entries"] <= entries // 16
        if r["kind"] == "train":
            assert {"gathered_f32", "row_gradients", "activations"} <= set(mem["detail"])
            # each row's gathers, the rows' gradients to dev0 and the slices back
            assert set(r["collectives"]) == {"all-gather", "collective-permute"}
            assert r["compute_entries"] == r["data_rows"] == entries // 16
        else:
            assert "rest_of_model" in mem["detail"] and r["collectives"] == {}


def test_dryrun_pins_the_cells_that_do_not_fit(records):
    got = {(r["arch"], r["shape"], r["mesh"]) for r in records
           if r["status"] == "ok" and r["kind"] != "mining" and not r["memory"]["fits"]}
    assert got == NOT_FITTING
    # a whole float32 copy of the model and its gradients sit on dev0 whatever the mesh
    numel = {n: sum(p.numel() for p in build(ARCHS[n]).abstract_params().parameters())
             for n in ARCHS}
    for r in records:
        if r["status"] == "ok" and r["kind"] == "train":
            d = r["memory"]["detail"]
            assert d["gathered_f32"] == 4 * numel[r["arch"]], r["arch"]
            assert d["row_gradients"] >= d["gathered_f32"], r["arch"]


def test_mining_rows_price_the_port_on_the_h100(records):
    rows = {(r["arch"], r["mesh"]): r for r in records if r.get("kind") == "mining"}
    tiled = rows[("kyiv-mining-count-tiled", "pod16x16")]["roofline"]
    assert tiled["t_compute"] != 3.27e-05 and "H100" in tiled["t_compute_from"]
    assert tiled["t_memory"] == tiled["hbm_bytes_per_dev"] / H100.hbm_bw
    count = rows[("kyiv-mining-count", "pod16x16")]
    assert (count["pair_shards"], count["word_shards"]) == (16, 16)
    assert rows[("kyiv-mining-count", "pod2x16x16")]["pair_shards"] == 32
    # the partial counts summed onto the pair shard's first entry
    assert count["collectives"] == {"collective-permute": 1}
    assert count["roofline"]["t_collective"] > 0
    terms = dryrun.mining_terms(65_536, 31_252, 16_384, 1, 1, write=False)
    assert terms["roofline"]["t_collective"] == 0 and terms["collectives"] == {}


def test_live_bytes_counts_what_the_step_holds():
    x = torch.empty(1000, device="meta", requires_grad=True)
    with dryrun._LiveBytes() as live:
        y = (x * 2).exp()  # exp keeps its output (4,000 B) for the backward
        z = y.view(10, 100)  # a view holds no storage of its own
        loss = z.sum()
        peak_forward = live.peak
        loss.backward()
        del y, z
    assert peak_forward == 4000 + 4000  # x * 2 and its exp, before x * 2 is freed
    assert live.live == 4000 + 4  # x's gradient and the loss; the rest is freed
    c = torch.empty(1000, device="meta")
    with dryrun._LiveBytes() as live:
        c.mul_(2)  # in place on a tensor from outside (a cache): nothing new
    assert live.peak == 0


def test_lower_cell_on_a_small_mesh():
    mesh = mesh_from_spec("2x2", devices=["meta"] * 4)
    rec = dryrun.lower_cell("granite-moe-1b-a400m", ShapeConfig("s", 2048, 8, "train"),
                            mesh=mesh)
    assert rec["mesh"] == "2x2" and rec["compute_entries"] == 2 and rec["row_batch"] == 4
    # the second row's gradients go to dev0: the sum is dev0's own
    detail = rec["roofline"]["bytes_detail"]
    assert set(dryrun.ROW_TERMS) < set(detail) and detail["gradient_sum"] > 0
    one = dryrun.lower_cell("granite-moe-1b-a400m", ShapeConfig("s", 2048, 8, "train"),
                            mesh=mesh_from_spec("1x1", devices=["meta"]))
    # one entry: no copy between entries
    assert one["collectives"] == {"all-gather": len(dict(
        build(ARCHS["granite-moe-1b-a400m"]).abstract_params().named_parameters()))}
    assert one["roofline"]["t_collective"] == 0
    assert one["roofline"]["bytes_detail"]["gradient_sum"] == 0
    assert one["roofline"]["t_compute"] == pytest.approx(
        dryrun.analytic_work(ARCHS["granite-moe-1b-a400m"],
                             ShapeConfig("s", 2048, 8, "train"), 1).flops / H100.peak_bf16_flops)


def _deepened(name: str, periods: int = 4):
    cfg = reduced(ARCHS[name])
    n = (cfg.moe.first_dense if cfg.moe is not None else 0) + periods * len(cfg.pattern)
    return dataclasses.replace(cfg, n_layers=n, enc_layers=n if cfg.enc_layers else 0)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_extrapolated_trace_equals_the_whole_depth(name):
    cfg = _deepened(name)
    train = ShapeConfig("t", 32, 4, "train")
    for rows, partial in ((4, False), (2, True)):
        got = dryrun._train_activations(cfg, train, rows, partial, None)
        want = dryrun._train_trace(cfg, train, rows, partial, None, cfg.n_layers)
        assert got == want, (rows, partial, got, want)
    decode = ShapeConfig("d", 32, 2, "decode")
    assert dryrun._decode_transients(cfg, decode, 2) == dryrun._decode_trace(cfg, decode, 2,
                                                                             cfg.n_layers)
    prefill = ShapeConfig("p", 32, 2, "prefill")
    assert dryrun._prefill_transients(cfg, prefill, 2) == 2 * dryrun._prefill_trace(
        cfg, prefill, cfg.n_layers)
