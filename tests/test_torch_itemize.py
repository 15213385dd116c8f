"""The item table built on a device (``repro_torch.kernels.itemize``): its
plain PyTorch version on the CPU against the host ``_itemize`` and the
reference package's ``itemize``, field for field, on both column routes
(dense: a slot table and its scan; sorted: a sort of the column), and the
routing of ``core.kyiv.prepare`` through the ``itemize`` span's ``path``.
The CUDA kernels' own checks are in ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import itemize as r_itemize
from repro_torch.core import KyivConfig, itemize, prepare
from repro_torch.core.items import _itemize
from repro_torch.core.placement import MeshPlacement
from repro_torch.kernels.itemize import itemize_on_device
from repro_torch.launch.mesh import mesh_from_spec
from repro_torch.obs.trace import TRACER
from test_torch_itemize_helpers import CASES, I64, ROWS, assert_same_table, mixed


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_itemize_equals_host_and_reference(case, n):
    D = CASES[case](n)
    got, attrs = itemize_on_device(D, "cpu", "torch")
    want = _itemize(D)
    assert_same_table(got, want)
    assert_same_table(got, r_itemize(D))
    assert attrs["path"] == "torch"
    assert attrs["dense_cols"] + attrs["sorted_cols"] == D.shape[1]
    assert attrs["bytes_up"] == D.nbytes + D.shape[1] * 5 * 8


@pytest.mark.parametrize("n,routes", [(1, (8, 0)), (33, (4, 4)), (1000, (5, 3))])
def test_route_per_column_follows_its_range(n, routes):
    """A column whose range holds at most n values is dense, any other
    sorted: at n = 1 every column is constant, hence dense."""
    _, attrs = itemize_on_device(mixed(n, 9), "cpu", "torch")
    assert (attrs["dense_cols"], attrs["sorted_cols"]) == routes


@pytest.mark.parametrize(
    "D",
    [np.zeros((0, 3), dtype=np.int64), np.zeros((4, 0), dtype=np.int64),
     np.zeros((4, 2), dtype=np.float64), np.zeros((4, 2), dtype=np.uint64),
     np.zeros((4, 2), dtype=bool), np.zeros((4, 2), dtype=">i8")],
    ids=["no_rows", "no_columns", "float", "uint64", "bool", "big_endian"],
)
def test_device_itemize_refuses_what_the_host_keeps(D):
    with pytest.raises(ValueError):
        itemize_on_device(D, "cpu", "torch")


tables_st = st.integers(1, 70).flatmap(
    lambda n: st.lists(
        st.one_of(
            st.lists(st.integers(-3, 3), min_size=n, max_size=n),
            st.lists(st.integers(I64.min, I64.max), min_size=n, max_size=n),
            st.lists(st.sampled_from([I64.min, 0, I64.max]), min_size=n, max_size=n),
        ),
        min_size=1, max_size=6,
    )
)


@given(tables_st)
@settings(max_examples=80, deadline=None)
def test_device_itemize_equals_host_on_drawn_tables(columns):
    D = np.array(columns, dtype=np.int64).T.copy()
    got, _ = itemize_on_device(D, "cpu", "torch")
    assert_same_table(got, _itemize(D))
    assert_same_table(got, r_itemize(D))


def _prepare_path(D, config):
    with TRACER.start("request") as root:
        prep = prepare(D, config)
    trace = TRACER.last(1)[0]
    assert trace.root is root
    (sp,) = trace.find("itemize")
    return prep, sp.attrs


@pytest.mark.parametrize(
    "engine,dtype,path",
    [("numpy", np.int64, "host"), ("torch", np.int64, "torch"), ("cuda", np.int32, "torch"),
     ("torch", np.float64, "host"), ("torch", np.uint64, "host")],
)
def test_prepare_routes_by_placement_and_dtype(engine, dtype, path):
    D = np.random.default_rng(5).integers(0, 4, size=(300, 6)).astype(dtype)
    cfg = KyivConfig(tau=1, kmax=3, engine=engine, device="cpu")
    prep, attrs = _prepare_path(D, cfg)
    assert attrs["path"] == path
    assert ("dense_cols" in attrs) == (path != "host")
    want = prepare(_itemize(D), cfg)
    for name in ("uniform_items", "infrequent_items", "l_items", "l_bits", "l_freq"):
        assert np.array_equal(getattr(prep, name), getattr(want, name)), name
    assert_same_table(prep.table, want.table)


def test_prepare_on_a_mesh_and_direct_itemize_keep_the_host():
    D = np.random.default_rng(6).integers(0, 4, size=(200, 5))
    mesh = MeshPlacement(mesh_from_spec("2x2", devices=["cpu"] * 4), word_axis="model", engine="torch")
    _, attrs = _prepare_path(D, KyivConfig(tau=1, kmax=3, placement=mesh))
    assert attrs == {"path": "host"}
    with TRACER.start("request"):
        itemize(D)
    assert TRACER.last(1)[0].find("itemize")[0].attrs == {"path": "host"}
