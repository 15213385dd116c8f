"""The GPipe schedule (``repro_torch.distributed.pipeline``) and
sequence-sharded decode attention (``repro_torch.serving.decode_attn``) on
CPU entries, against the port's own single-device functions and against the
reference's on the same inputs (one subprocess on 8 forced host devices,
``Auto`` axes).

* ``bubble_fraction``: the reference test's three equalities.
* A 4-stage pipeline of ``tanh(x @ w + b)`` stages (D = 16, 8 micro-batches
  of 4 rows) against the sequential stack and against the reference's
  ``pipeline_forward``: within 1e-5 relative and absolute (the reference
  test's ``assert_allclose``).
* The reference test's three decode-attention cases (8 shards of the cache
  sequence; a window in the third) and a fourth whose lengths leave the
  last shards' whole slices past every length, against the port's
  ``decode_attention`` on the whole cache and the reference's
  ``seq_sharded_decode_attention``: within 2e-5 relative and absolute.
"""

import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import bubble_fraction, pipeline_forward
from repro_torch.launch.mesh import mesh_from_shape
from repro_torch.models.layers.attention import decode_attention
from repro_torch.serving.decode_attn import seq_sharded_decode_attention
from test_torch_dist_helpers import run_reference

S, D, MICRO = 4, 16, 8
CASES = [(2, 64, 4, 2, 16, 0), (1, 128, 8, 1, 8, 0), (2, 64, 4, 4, 16, 24),
         (2, 64, 4, 2, 16, 0)]


def _pipe_inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((S, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((MICRO * 4, D)).astype(np.float32)
    return w, b, x


def _attn_inputs():
    rng = np.random.default_rng(0)
    out = []
    for i, (b, L, h, kv, hd, window) in enumerate(CASES):
        q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
        k = rng.standard_normal((b, L, kv, hd)).astype(np.float32)
        v = rng.standard_normal((b, L, kv, hd)).astype(np.float32)
        lengths = rng.integers(L // 2, L + 1, b).astype(np.int32)
        if i == 3:  # shards 5-7 (positions 40-63) lie past every length
            lengths = np.array([37, 12], np.int32)
        out.append((q, k, v, lengths, window))
    return out


_REF = r"""
import jax.numpy as jnp
from repro.distributed.pipeline import pipeline_forward
from repro.serving.decode_attn import seq_sharded_decode_attention

w, b, x = IN["pipe"]
fwd = pipeline_forward(auto_mesh((S,), ("stage",)), lambda p, xb: jnp.tanh(xb @ p["w"] + p["b"]),
                       n_micro=MICRO)
OUT["pipe"] = np.asarray(jax.jit(fwd)({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                      jnp.asarray(x)))
mesh = auto_mesh((8,), ("data",))
OUT["attn"] = [np.asarray(jax.jit(seq_sharded_decode_attention(mesh, seq_axis="data",
                                                               window=window))(
    jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)))
    for q, k, v, lengths, window in IN["attn"]]
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(f"S, D, MICRO = {S}, {D}, {MICRO}\n" + _REF,
                         tmp_path_factory.mktemp("ref_pipe"),
                         inputs={"pipe": _pipe_inputs(), "attn": _attn_inputs()})


def test_bubble_fraction():
    assert bubble_fraction(1, 8) == 0.0
    assert abs(bubble_fraction(4, 13) - 3 / 16) < 1e-12
    assert bubble_fraction(4, 4) == 3 / 7


def test_pipeline_matches_sequential_and_reference(reference):
    w, b, x = (torch.as_tensor(a) for a in _pipe_inputs())
    mesh = mesh_from_shape((S,), ("stage",), ["cpu"] * S)
    calls = []

    def stage(p, xb):
        calls.append(xb.shape[0])
        return torch.tanh(xb @ p["w"] + p["b"])

    y = pipeline_forward(mesh, stage, n_micro=MICRO)({"w": w, "b": b}, x)
    assert calls == [4] * S * MICRO  # each stage once per micro-batch
    ref = x
    for s in range(S):
        ref = torch.tanh(ref @ w[s] + b[s])
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), reference["pipe"], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        pipeline_forward(mesh_from_shape((2, 2), ("data", "model"), ["cpu"] * 4), stage,
                         n_micro=2)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_seq_sharded_decode_attention(reference, case):
    q, k, v, lengths, window = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                for a in _attn_inputs()[case])
    mesh = mesh_from_shape((8,), ("data",), ["cpu"] * 8)
    out = seq_sharded_decode_attention(mesh, seq_axis="data", window=window)(q, k, v, lengths)
    want = decode_attention(q, k, v, lengths, window=window)
    assert out.shape == q.shape and out.dtype == q.dtype
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), reference["attn"][case], rtol=2e-5, atol=2e-5)
