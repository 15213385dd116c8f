"""The port's frontier bodies (torch ops) against the reference's traced
jnp bodies and its numpy mirrors (``kernels/frontier/ref.py``), and the
device placement's candidate generation against the host path. Integer ops:
tolerance is zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.prefix import Level as RLevel
from repro.core.prefix import generate_candidates as r_generate_candidates
from repro.core.support import ItemsetIndex as RItemsetIndex
from repro.core.support import support_test as r_support_test
from repro.kernels.frontier import frontier as jf
from repro.kernels.frontier import ops as jops
from repro.kernels.frontier import ref as fref
from repro_torch.core.placement import DevicePlacement
from repro_torch.core.prefix import group_reps, iter_group_spans, prefix_group_sizes
from repro_torch.kernels.frontier import frontier as tf
from repro_torch.kernels.frontier import ops as tops
from repro_torch.kernels.frontier import ref as tref


def _rand_level(t_target, k, n_symbols, seed):
    """A lex-sorted level table with realistic prefix groups (rows strictly
    increasing, as the prefix-tree invariant requires)."""
    rng = np.random.default_rng(seed)
    rows: set[tuple] = set()
    tries = 0
    while len(rows) < t_target and tries < 50 * t_target:
        tries += 1
        if k == 1:
            rows.add((int(rng.integers(0, n_symbols)),))
            continue
        prefix = tuple(sorted(int(x) for x in rng.choice(n_symbols, size=k - 1, replace=False)))
        for last in rng.choice(n_symbols, size=int(rng.integers(1, 6)), replace=False):
            if int(last) > prefix[-1]:
                rows.add(prefix + (int(last),))
    its = np.asarray(sorted(rows), dtype=np.int32)
    counts = rng.integers(1, 50, size=len(its)).astype(np.int64)
    return its, counts


def test_numpy_mirrors_are_the_reference_ones():
    its, _ = _rand_level(40, 3, 300, seed=1)
    for n_symbols in (300, 70_000):
        assert np.array_equal(tref.pack_rows_np(its, n_symbols), fref.pack_rows_np(its, n_symbols))
        tp = tops.table_pad(len(its))
        assert tp == jops.table_pad(len(its))
        assert np.array_equal(tref.key_table_np(its, n_symbols, tp), fref.key_table_np(its, n_symbols, tp))
    for n_symbols, k in ((2, 1), (40, 2), (300, 5), (70_000, 4)):
        assert tf.pack_params(n_symbols, k) == jf.pack_params(n_symbols, k)


@pytest.mark.parametrize("n_symbols,k", [(40, 2), (1000, 3), (90_000, 4)])
def test_lookup_keys_match_jax_and_numpy(n_symbols, k):
    """Multiword keys (90,000 symbols -> 17 bits, one item per word)."""
    its, _ = _rand_level(80, k, n_symbols, seed=n_symbols)
    t_pad = tops.table_pad(its.shape[0])
    table = fref.key_table_np(its, n_symbols, t_pad)
    rng = np.random.default_rng(1)
    present = its[rng.integers(0, its.shape[0], size=30)]
    absent = present.copy()
    absent[:, -1] = (absent[:, -1] + 1) % n_symbols
    b, ipw, w = tf.pack_params(n_symbols, k)
    for q in (present, absent):
        want = RItemsetIndex(its, None, n_symbols=n_symbols).lookup(q) >= 0
        assert np.array_equal(fref.lookup_np(table, fref.pack_rows_np(q, n_symbols)), want)
        tq = tf.pack_cols([torch.from_numpy(q[:, c]) for c in range(k)], b, ipw)
        jq = jf.pack_cols([jnp.asarray(q[:, c]) for c in range(k)], b, ipw)
        assert tq.shape[1] == w and np.array_equal(tq.numpy(), np.asarray(jq))
        got = tf.lookup_keys(torch.from_numpy(table), tq, t_pad=t_pad).numpy()
        jgot = np.asarray(jf.lookup_keys(jnp.asarray(table), jq, t_pad=t_pad))
        assert np.array_equal(got, want) and np.array_equal(jgot, want)
        pos = tf.lower_bound(torch.from_numpy(table), tq, t_pad=t_pad).numpy()
        jpos = np.asarray(jf.lower_bound(jnp.asarray(table), jq, t_pad=t_pad))
        assert np.array_equal(pos, jpos)


@pytest.mark.parametrize(
    "reps,lo,bucket",
    [
        ([3, 2, 1, 0], 0, 8),  # bucket > total: the padding rows repeat the last row
        ([3, 2, 1, 0, 0, 0, 0, 0], 5, 256),
        ([0, 4, 3, 2, 1, 0, 0, 0], 2, 16),
        ([1], 7, 1),  # bucket == total
        ([5, 4, 3, 2, 1, 0, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0], 11, 32),
    ],
)
def test_gen_pairs_matches_jax_and_numpy(reps, lo, bucket):
    reps = np.asarray(reps, dtype=np.int32)
    mb = int(reps.sum())
    i, j, valid = tf.gen_pairs_body(torch.from_numpy(reps), lo, mb, bucket=bucket)
    ji, jj, jv = jf.gen_pairs_body(jnp.asarray(reps), jnp.int32(lo), jnp.int32(mb), bucket=bucket)
    ni, nj, nv = tref.gen_pairs_np(reps, lo, mb, bucket)
    for got, want in ((i, ji), (j, jj), (valid, jv)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(i.numpy(), ni) and np.array_equal(j.numpy(), nj)
    assert np.array_equal(valid.numpy(), nv)
    assert i.dtype == torch.int32 and j.dtype == torch.int32


@pytest.mark.parametrize("k,n_symbols", [(2, 40), (3, 300), (4, 70_000)])
def test_gen_support_body_matches_jax(k, n_symbols):
    its, _ = _rand_level(60, k, n_symbols, seed=k)
    ids, keys, tp = tops.make_level_tables(its, n_symbols)
    jids, jkeys, jtp = jops.make_level_tables(its, n_symbols)
    assert tp == jtp and np.array_equal(ids, jids) and np.array_equal(keys, jkeys)
    b, ipw, _ = tf.pack_params(n_symbols, k)
    reps = group_reps(its).astype(np.int32)
    sizes = prefix_group_sizes(its)
    for lo, hi, n_pairs in iter_group_spans(sizes, 37):
        if n_pairs == 0:
            continue
        rb, bucket = tops.gen_buckets(hi - lo, n_pairs)
        assert (rb, bucket) == jops.gen_buckets(hi - lo, n_pairs)
        reps_b = tops.pad_reps(reps[lo:hi], rb)
        pairs, ok = tf.gen_support_body(
            torch.from_numpy(ids), torch.from_numpy(keys), torch.from_numpy(reps_b), lo, n_pairs,
            k=k, bucket=bucket, t_pad=tp, bits=b, ipw=ipw,
        )
        jpairs, jok = jf.gen_support_body(
            jnp.asarray(ids), jnp.asarray(keys), jnp.asarray(reps_b), jnp.int32(lo),
            jnp.int32(n_pairs), k=k, bucket=bucket, t_pad=tp, bits=b, ipw=ipw,
        )
        assert np.array_equal(pairs.numpy(), np.asarray(jpairs))
        assert np.array_equal(ok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("k,n_symbols", [(1, 30), (2, 40), (3, 300), (4, 70_000)])
def test_device_frontier_dispatch_matches_host_reference(k, n_symbols):
    its, counts = _rand_level(60, k, n_symbols, seed=k + 10)
    if its.shape[0] < 2:
        pytest.skip("degenerate level")
    cand = r_generate_candidates(RLevel(k=k, itemsets=its, counts=counts, bits=None))
    ok_host = r_support_test(cand.itemsets, RItemsetIndex(its, counts, n_symbols=n_symbols))
    dev = DevicePlacement("torch", device="cpu")
    state = dev.prepare_frontier(its, counts, n_symbols)
    got_i, got_j, got_ok = [], [], []
    for lo, hi, n_pairs in iter_group_spans(prefix_group_sizes(its), 1 << 22):
        if n_pairs == 0:
            continue
        pairs, ok = dev.frontier_dispatch(state, lo, hi, n_pairs)
        pairs, ok = pairs.numpy(), ok.numpy()
        got_i.append(pairs[:n_pairs, 0])
        got_j.append(pairs[:n_pairs, 1])
        got_ok.append(ok[:n_pairs])
        assert not ok[n_pairs:].any(), "padding rows must be not-ok"
    dev.release(state)
    assert "ids" not in state and "keys" not in state
    assert np.array_equal(np.concatenate(got_i), cand.i_idx)
    assert np.array_equal(np.concatenate(got_j), cand.j_idx)
    assert np.array_equal(np.concatenate(got_ok), ok_host)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_pruned_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, 9, size=(64, 2)).astype(np.int32)
    ok = rng.random(64) < 0.5
    out, n_ok = tf.mask_pruned_body(torch.from_numpy(pairs), torch.from_numpy(ok))
    jout, jn = jf.mask_pruned_body(jnp.asarray(pairs), jnp.asarray(ok))
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert int(n_ok) == int(jn) == ok.sum() and n_ok.dtype == torch.int32
    assert np.array_equal(out.numpy()[ok], pairs[ok])  # survivors untouched, in place
    assert np.all(out.numpy()[~ok, 0] == out.numpy()[~ok, 1])  # pruned -> self-pairs


@pytest.mark.parametrize("seed,b", [(0, 512), (1, 7), (2, 1), (3, 256)])
def test_partition_is_a_stable_class_argsort(seed, b):
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, 3, size=b).astype(np.int32)
    order, n_emit, n_store = tf.partition_body(torch.from_numpy(classes))
    jorder, je, js = jf.partition_body(jnp.asarray(classes))
    ref_order, ref_e, ref_s = tref.partition_np(classes)
    assert np.array_equal(order.numpy(), ref_order) and np.array_equal(order.numpy(), np.asarray(jorder))
    assert (int(n_emit), int(n_store)) == (ref_e, ref_s) == (int(je), int(js))
