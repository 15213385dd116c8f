"""The sharding plan (``repro_torch.distributed.sharding``) against the
reference's ``make_plan`` on the same mesh shapes, spec by spec.

The reference runs in one subprocess on 16 forced host devices with
``Auto`` axes. For the ten full-width configurations (abstract parameters:
the meta device here, ``eval_shape`` there) on 2x2 and 4x4: every port
parameter's spec equals the reference's for the leaf it came from (a
stacked leaf's leading ``None`` dropped: the port holds one tensor per
layer), in train and serve mode, and the fallbacks are the reference's as
sets (the port meets a stacked leaf once per layer). The mapping of port
names to reference leaves is ``convert.lm_params_from_numpy`` itself, run
on a tree of leaf ids. Also the batch specs (B = 8, and B = 6, which
falls back), the cache specs of qwen1.5-110b (KV heads on ``model``),
recurrentgemma-9b (MQA: ``head_dim``) and deepseek-v2-lite-16b
(``c_kv``/``k_rope``), and ``ShardCtx.axis_size``/``resolve``. Specs are
compared after a one-name tuple is normalised to its name. No tolerance:
specs are exact.
"""

import numpy as np
import pytest

from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.sharding import make_plan
from repro_torch.launch.mesh import mesh_from_spec
from repro_torch.models.layers.common import ShardCtx
from repro_torch.models.zoo import build
from test_torch_dist_helpers import norm_spec, run_reference
from test_torch_lm_helpers import ref_cache_layers

SHAPES = ("2x2", "4x4")
CACHE_ARCHS = ("qwen1.5-110b", "recurrentgemma-9b", "deepseek-v2-lite-16b")
CACHE_B, CACHE_L = 8, 128

_REF = r"""
from jax.tree_util import DictKey, tree_flatten_with_path
from repro.configs import ARCHS
from repro.distributed.sharding import make_plan
from repro.models.zoo import build

MARKERS = {"groups", "enc_layers", "dec_layers"}


def id_tree(tree, specs_of):
    # each leaf -> an id array (one id per stacked layer), and id -> spec
    flat, treedef = tree_flatten_with_path(tree)
    specs, leaves = specs_of(tree), []
    flat_specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    table = {}
    for i, ((path, leaf), sh) in enumerate(zip(flat, flat_specs)):
        names = [str(k.key) for k in path if isinstance(k, DictKey)]
        stacked = bool(MARKERS & set(names))
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(tuple(sh.spec)))
        table[i] = [list(e) if isinstance(e, tuple) else e for e in (spec[1:] if stacked else spec)]
        leaves.append(np.full(leaf.shape[:1], i) if stacked else np.array(i))
    return jax.tree.unflatten(treedef, leaves), table


for shape in SHAPES:
    d, m = map(int, shape.split("x"))
    mesh = auto_mesh((d, m), ("data", "model"))
    for name in sorted(ARCHS):
        model = build(ARCHS[name])
        aparams = model.abstract_params()
        rec = {}
        for serve in (False, True):
            plan = make_plan(mesh, serve=serve)
            ids, table = id_tree(aparams, plan.param_shardings)
            rec["serve" if serve else "train"] = {"ids": ids, "specs": table,
                                                   "fallbacks": sorted(plan.fallbacks)}
        for b in (8, 6):
            plan = make_plan(mesh)
            cfg = ARCHS[name]
            batch = {"tokens": jax.ShapeDtypeStruct((b, 16), np.int32),
                     "labels": jax.ShapeDtypeStruct((b, 16), np.int32)}
            if cfg.frontend == "audio_stub":
                batch["frames"] = jax.ShapeDtypeStruct((b, 16, cfg.d_model), np.float32)
            if cfg.frontend == "vision_stub":
                batch["patches"] = jax.ShapeDtypeStruct((b, cfg.n_patches, cfg.d_model), np.float32)
            sh = plan.batch_shardings(batch)
            rec[f"batch{b}"] = {k: [list(e) if isinstance(e, tuple) else e for e in v.spec]
                                for k, v in sh.items()}
            rec[f"batch{b}_fallbacks"] = sorted(plan.fallbacks)
        if name in CACHE_ARCHS:
            plan = make_plan(mesh)
            acache = model.init_cache(CACHE_B, CACHE_L, abstract=True)
            rec["cache"] = id_tree(acache, plan.cache_shardings)
            rec["cache_fallbacks"] = sorted(plan.fallbacks)
        OUT[(name, shape)] = rec
    ctx = make_plan(mesh).ctx()
    OUT[("ctx", shape)] = [ctx.axis_size(("data",)), ctx.axis_size("model"), ctx.axis_size(None),
                           ctx.axis_size(("data", "model")), ctx.resolve("dp"),
                           ctx.resolve("tp"), ctx.resolve(None)]
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"SHAPES = {SHAPES!r}\nCACHE_ARCHS = {CACHE_ARCHS!r}\nCACHE_B, CACHE_L = {CACHE_B}, {CACHE_L}\n"
    return run_reference(body + _REF, tmp_path_factory.mktemp("ref_plan"), n_devices=16)


def _plan(shape, **kw):
    d, m = map(int, shape.split("x"))
    return make_plan(mesh_from_spec(shape, devices=["cpu"] * (d * m)), **kw)


def _ref_leaf_ids(ids: dict, cfg) -> dict:
    """Port name -> reference leaf id, by ``lm_params_from_numpy`` on the id tree."""
    tree = {"prefix": [], "suffix": [], **ids}
    return {n: int(t) for n, t in lm_params_from_numpy(tree, cfg).items()}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_match_reference(reference, name, shape):
    cfg = ARCHS[name]
    net = build(cfg).abstract_params()
    rec = reference[(name, shape)]
    for mode in ("train", "serve"):
        plan = _plan(shape, serve=mode == "serve")
        got = plan.param_shardings(net)
        ids = _ref_leaf_ids(rec[mode]["ids"], cfg)
        assert sorted(ids) == sorted(got)
        for n, spec in got.items():
            assert len(spec) == net.get_parameter(n).dim(), n
            assert norm_spec(spec) == norm_spec(rec[mode]["specs"][ids[n]]), (mode, n, spec)
        assert sorted(set(plan.fallbacks)) == sorted(set(rec[mode]["fallbacks"])), mode


def test_fallbacks_and_coverage_at_full_width(reference):
    """The fallbacks the reference records, and how many leaves a plan splits."""
    want = {"granite-moe-1b-a400m": ["embedding[dim0]=49155 !% model"],
            "internvl2-26b": ["embedding[dim0]=92553 !% model", "lm_head[dim1]=92553 !% model"],
            "whisper-medium": ["embedding[dim0]=51865 !% model", "lm_head[dim1]=51865 !% model"]}
    for shape in SHAPES:
        for name in sorted(ARCHS):
            plan = _plan(shape)
            specs = plan.param_shardings(build(ARCHS[name]).abstract_params())
            assert sorted(set(plan.fallbacks)) == want.get(name, []), (name, shape)
            assert sorted(set(reference[(name, shape)]["train"]["fallbacks"])) == \
                want.get(name, [])
            assert any(any(e is not None for e in s) for s in specs.values()), name


@pytest.mark.parametrize("shape", SHAPES)
def test_batch_specs_match_reference(reference, shape):
    for name in sorted(ARCHS):
        cfg = ARCHS[name]
        for b in (8, 6):
            plan = _plan(shape)
            batch = {"tokens": np.zeros((b, 16)), "labels": np.zeros((b, 16))}
            if cfg.frontend == "audio_stub":
                batch["frames"] = np.zeros((b, 16, 1))
            if cfg.frontend == "vision_stub":
                batch["patches"] = np.zeros((b, cfg.n_patches, 1))
            got = {k: norm_spec(v) for k, v in plan.batch_shardings(batch).items()}
            want = {k: norm_spec(v) for k, v in reference[(name, shape)][f"batch{b}"].items()}
            assert got == want, (name, b)
            assert sorted(plan.fallbacks) == reference[(name, shape)][f"batch{b}_fallbacks"]
            assert (got["tokens"][0] is None) == (b % plan._size(plan.dp) != 0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", CACHE_ARCHS)
def test_cache_specs_match_reference(reference, name, shape):
    cfg = ARCHS[name]
    plan = _plan(shape)
    cache = build(cfg).init_cache(CACHE_B, CACHE_L, device="meta")
    got = plan.cache_shardings(cache)
    ids_tree, table = reference[(name, shape)]["cache"]
    ids = ref_cache_layers(cfg, ids_tree)
    assert len(ids) == len(got)
    seen = set()
    for layer, (g, i) in enumerate(zip(got, ids)):
        assert sorted(g) == sorted(i), layer
        for k, spec in g.items():
            assert norm_spec(spec) == norm_spec(table[int(i[k])]), (layer, k, spec)
            seen.add((k, norm_spec(spec)))
    assert sorted(set(plan.fallbacks)) == sorted(set(reference[(name, shape)]["cache_fallbacks"]))
    # the chain each configuration exercises
    tp = "model"
    if name == "qwen1.5-110b":
        assert ("k", ("data", None, tp, None)) in seen
    elif name == "recurrentgemma-9b":
        assert ("k", ("data", None, None, tp)) in seen
    else:
        assert ("c_kv", ("data", None, tp)) in seen and ("k_rope", ("data", None, tp)) in seen


@pytest.mark.parametrize("shape", SHAPES)
def test_shard_ctx_matches_reference(reference, shape):
    ctx = _plan(shape).ctx()
    got = [ctx.axis_size(("data",)), ctx.axis_size("model"), ctx.axis_size(None),
           ctx.axis_size(("data", "model")), ctx.resolve("dp"), ctx.resolve("tp"),
           ctx.resolve(None)]
    want = reference[("ctx", shape)]
    assert got[:4] == want[:4] and got[5:] == want[5:]
    assert tuple(got[4]) == tuple(want[4])
    assert ShardCtx().axis_size(("data",)) == 1 and ShardCtx().resolve("dp") is None
    with pytest.raises(ValueError):
        ctx.resolve("sp")
