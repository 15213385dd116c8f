"""The LM port's layers against the reference's, one function at a time, on
the same seeded numpy inputs and the same weights (the reference's init,
carried into the port's module). Float32 at rtol = atol = 1e-5 unless a
test says why it is looser."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLACfg, MoECfg, SSMCfg
from repro.models.layers import attention as R_att
from repro.models.layers import mla as R_mla
from repro.models.layers import mlp as R_mlp
from repro.models.layers import moe as R_moe
from repro.models.layers import rglru as R_rglru
from repro.models.layers import ssd as R_ssd
from repro.models.layers.common import rms_norm as r_rms_norm
from repro.models.layers.rope import apply_rope as r_apply_rope
from repro_torch.models.layers import attention as T_att
from repro_torch.models.layers import mla as T_mla
from repro_torch.models.layers import mlp as T_mlp
from repro_torch.models.layers import moe as T_moe
from repro_torch.models.layers import rglru as T_rglru
from repro_torch.models.layers import ssd as T_ssd
from repro_torch.configs import ARCHS, reduced
from repro_torch.models.layers.common import cast, rms_norm as t_rms_norm
from repro_torch.models.layers.embeddings import init_embed
from repro_torch.models.lm import init_lm
from repro_torch.models.layers.rope import apply_rope as t_apply_rope

TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.PRNGKey(0)

# the reference's composite layers, compiled whole (op by op they take seconds)
r_chunked = jax.jit(R_att.chunked_attention,
                    static_argnames=("causal", "block_q", "block_k"))
r_local = jax.jit(R_att.local_attention, static_argnames=("window", "block"))
r_decode_att = jax.jit(R_att.decode_attention, static_argnames=("window",))
r_mlp = jax.jit(R_mlp.apply_mlp, static_argnums=(2,))
r_moe = jax.jit(R_moe.apply_moe, static_argnums=(2,), static_argnames=("n_groups",))
r_mla_prefill = jax.jit(R_mla.mla_train_prefill, static_argnums=(2, 3, 4),
                        static_argnames=("return_cache",))
r_mla_decode = jax.jit(R_mla.mla_decode, static_argnums=(4, 5, 6))
r_rglru_train = jax.jit(R_rglru.rglru_train, static_argnames=("return_state",))
r_rglru_decode = jax.jit(R_rglru.rglru_decode)
r_ssd_scan = jax.jit(R_ssd.ssd_scan, static_argnums=(5,))
r_ssd_train = jax.jit(R_ssd.ssd_train, static_argnums=(2,), static_argnames=("return_state",))
r_ssd_decode = jax.jit(R_ssd.ssd_decode, static_argnums=(3,))


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               **(tol or TOL))


def _load(module, ref_params):
    """The port's module on the reference's weights."""
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                flat[f"{prefix}{k}"] = _t(np.asarray(v))

    walk("", ref_params)
    module.load_state_dict(flat, strict=True, assign=True)
    return module


# ---------------------------------------------------------------- the port's init


def test_init_from_a_generator():
    """The reference's init scheme on a torch.Generator: a normal truncated
    at +-2 sigma, sigma = fan_in ** -0.5 (the embedding's fan-in is d_model),
    zero norm scales, RG-LRU's lambda 0.7; one seed, one net."""
    with torch.no_grad():
        e = init_embed(torch.Generator().manual_seed(0), 512, 256, tie=False)
        for w, sigma in ((e.embedding, 256 ** -0.5), (e.lm_head, 256 ** -0.5)):
            assert float(w.abs().max()) <= 2 * sigma
            # the std of a normal truncated at +-2 sigma is 0.880 sigma
            assert abs(float(w.std()) / sigma - 0.880) < 0.01
        mla = T_mla.init_mla(torch.Generator().manual_seed(0), 64, 4, MLA_CFG)
        assert float(mla.kv_norm.abs().max()) == 0 and float(mla.w_uk.abs().max()) <= 2 * 32 ** -0.5
        nets = [init_lm(reduced(ARCHS["recurrentgemma-9b"]), torch.Generator().manual_seed(s))
                for s in (3, 3, 4)]
        a, b, c = (dict(n.named_parameters()) for n in nets)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["layers.0.rglru.w_in"], c["layers.0.rglru.w_in"])
        assert torch.equal(a["layers.0.rglru.lam"], torch.full((64,), 0.7))
        assert float(a["final_norm"].abs().max()) == 0 and float(a["layers.2.norm2"].abs().max()) == 0
        assert cast(a["final_norm"], "bfloat16").dtype == torch.bfloat16


# ---------------------------------------------------------------- rope, norm, mlp


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = _rng(1)
    x = _normal(rng, 2, 7, 4, 16)
    pos = rng.integers(0, 3000, (2, 7))
    _close(t_apply_rope(_t(x), _t(pos), theta), r_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_rms_norm():
    rng = _rng(2)
    x, scale = _normal(rng, 3, 5, 64), _normal(rng, 64)
    _close(t_rms_norm(_t(x), _t(scale)), r_rms_norm(jnp.asarray(x), jnp.asarray(scale)))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "squared_relu"])
def test_mlp(act):
    p = R_mlp.init_mlp(KEY, 32, 48, act)
    m = _load(T_mlp.MLP(32, 48, act, device="meta"), p)
    x = _normal(_rng(3), 2, 5, 32)
    _close(T_mlp.apply_mlp(m, _t(x), act), r_mlp(p, jnp.asarray(x), act))


# ---------------------------------------------------------------- attention cores


@pytest.mark.parametrize("n_kv", [4, 2, 1])  # G = 1, 2, 4
@pytest.mark.parametrize("causal,sq,skv", [(True, 13, 13), (True, 16, 16), (False, 13, 13),
                                           (False, 16, 16), (False, 5, 11)])
def test_chunked_attention(causal, n_kv, sq, skv):
    """Blocks of 4 and 6: Sq = 13 pads the q blocks, Skv = 13 or 11 the kv blocks."""
    rng = _rng(4)
    q, k, v = _normal(rng, 2, sq, 4, 16), _normal(rng, 2, skv, n_kv, 16), _normal(rng, 2, skv, n_kv, 16)
    kw = dict(causal=causal, block_q=4, block_k=6)
    _close(T_att.chunked_attention(_t(q), _t(k), _t(v), **kw),
           r_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_distinct_v_width(causal):
    rng = _rng(5)
    q, k, v = _normal(rng, 2, 6, 4, 24), _normal(rng, 2, 14, 2, 24), _normal(rng, 2, 14, 2, 8)
    kw = dict(causal=causal, block_q=4, block_k=4)
    out = T_att.chunked_attention(_t(q), _t(k), _t(v), **kw)
    assert out.shape == (2, 6, 4, 8)
    _close(out, r_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


@pytest.mark.parametrize("s,window,block", [(29, 8, 4), (29, 8, None), (12, 16, None),
                                            (12, 12, 5), (40, 5, 8)])
@pytest.mark.parametrize("n_kv", [4, 1])
def test_local_attention(s, window, block, n_kv):
    """window < S (several blocks, padded q) and window >= S."""
    rng = _rng(6)
    q, k, v = _normal(rng, 2, s, 4, 16), _normal(rng, 2, s, n_kv, 16), _normal(rng, 2, s, n_kv, 16)
    kw = dict(window=window, block=block)
    _close(T_att.local_attention(_t(q), _t(k), _t(v), **kw),
           r_local(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("n_kv", [4, 2, 1])
def test_decode_attention_ragged(window, n_kv):
    """Ragged lengths (one row of a single entry, one full); a window masks
    slots before lengths - window."""
    rng = _rng(7)
    L = 12
    q, kc, vc = _normal(rng, 3, 1, 4, 16), _normal(rng, 3, L, n_kv, 16), _normal(rng, 3, L, n_kv, 16)
    lengths = np.array([1, 7, L], np.int32)
    _close(T_att.decode_attention(_t(q), _t(kc), _t(vc), _t(lengths), window=window),
           r_decode_att(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(lengths), window=window))


def test_decode_attention_full_ring():
    """A ring of L = window slots, all valid (lengths clipped to L), v wider."""
    rng = _rng(8)
    L = 8
    q, kc, vc = _normal(rng, 2, 1, 4, 16), _normal(rng, 2, L, 2, 16), _normal(rng, 2, L, 2, 24)
    lengths = np.array([L, L], np.int32)
    out = T_att.decode_attention(_t(q), _t(kc), _t(vc), _t(lengths))
    assert out.shape == (2, 1, 4, 24)
    _close(out, r_decode_att(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(lengths)))


# ---------------------------------------------------------------- MoE


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("n_groups", [1, 2])
def test_moe_capacity_drops(n_shared, n_groups):
    """A capacity factor of 0.25 over 40 tokens per group drops assignments
    (checked); the same ones must drop in both packages."""
    cfg = MoECfg(n_experts=4, top_k=2, d_expert=24, n_shared=n_shared, capacity_factor=0.25)
    p = R_moe.init_moe(KEY, 32, cfg)
    m = _load(T_moe.MoE(32, cfg, device="meta"), p)
    x = _normal(_rng(9), 4, 20, 32)
    tg = 80 // n_groups
    cap = R_moe.moe_capacity(tg, 4, 2, 0.25)
    assert T_moe.moe_capacity(tg, 4, 2, 0.25) == cap
    probs = jax.nn.softmax(jnp.asarray(x).reshape(n_groups, tg, 32) @ p["router"], axis=-1)
    ids = np.asarray(jax.lax.top_k(probs, 2)[1])
    assert max(np.bincount(g.ravel(), minlength=4).max() for g in ids) > cap  # some drop
    _close(T_moe.apply_moe(m, _t(x), cfg, n_groups=n_groups),
           r_moe(p, jnp.asarray(x), cfg, n_groups=n_groups))


def test_moe_no_drop_decode_shape():
    """One token per row (decode): capacity 8, nothing dropped."""
    cfg = MoECfg(n_experts=4, top_k=2, d_expert=24, n_shared=1)
    p = R_moe.init_moe(jax.random.PRNGKey(1), 32, cfg)
    m = _load(T_moe.MoE(32, cfg, device="meta"), p)
    x = _normal(_rng(10), 3, 1, 32)
    _close(T_moe.apply_moe(m, _t(x), cfg), r_moe(p, jnp.asarray(x), cfg))


# ---------------------------------------------------------------- MLA

MLA_CFG = MLACfg(kv_lora=32, rope_head_dim=8, nope_head_dim=16, v_head_dim=16)


def test_mla_prefill_and_decode():
    H, D, S = 4, 64, 9
    p = R_mla.init_mla(KEY, D, H, MLA_CFG)
    m = _load(T_mla.MLA(D, H, MLA_CFG, device="meta"), p)
    x = _normal(_rng(11), 2, S + 1, D)
    out_r, cache_r = r_mla_prefill(p, jnp.asarray(x[:, :S]), H, MLA_CFG, 1e4, return_cache=True)
    out_t, cache_t = T_mla.mla_train_prefill(m, _t(x[:, :S]), H, MLA_CFG, 1e4, return_cache=True)
    _close(out_t, out_r)
    for k in ("c_kv", "k_rope"):
        _close(cache_t[k], cache_r[k])
    # decode at ragged positions into a cache of S + 3 slots
    pad = lambda c: {k: jnp.pad(v, ((0, 0), (0, 3), (0, 0))) for k, v in c.items()}  # noqa: E731
    cr = pad(cache_r)
    ct = {k: _t(np.asarray(v)) for k, v in cr.items()}
    lengths = np.array([S, S - 4], np.int32)
    dr, cr2 = r_mla_decode(p, jnp.asarray(x[:, S:]), cr, jnp.asarray(lengths), H, MLA_CFG, 1e4)
    dt, ct2 = T_mla.mla_decode(m, _t(x[:, S:]), ct, _t(lengths), H, MLA_CFG, 1e4)
    _close(dt, dr)
    for k in ("c_kv", "k_rope"):
        _close(ct2[k], cr2[k])


# ---------------------------------------------------------------- RG-LRU


def test_rglru_train_state_and_decode():
    """The sequence form (a log-depth scan here, associative_scan there), its
    state and conv tail, from a start state, and two decode steps."""
    p = R_rglru.init_rglru(KEY, 32, 48)
    # non-zero biases and lambda, so the gates vary by channel
    rng = _rng(12)
    p = dict(p, b_a=jnp.asarray(_normal(rng, 48)), b_x=jnp.asarray(_normal(rng, 48)),
             lam=jnp.asarray(np.abs(_normal(rng, 48))))
    m = _load(T_rglru.RGLRU(32, 48, device="meta"), p)
    S = 13
    x = _normal(rng, 2, S + 2, 32)
    h0 = _normal(rng, 2, 48)
    _close(T_rglru.rglru_train(m, _t(x[:, :S]), initial_state=_t(h0)),
           r_rglru_train(p, jnp.asarray(x[:, :S]), initial_state=jnp.asarray(h0)))
    out_r, st_r = r_rglru_train(p, jnp.asarray(x[:, :S]), return_state=True)
    out_t, st_t = T_rglru.rglru_train(m, _t(x[:, :S]), return_state=True)
    _close(out_t, out_r)
    for step in range(2):
        xs = x[:, S + step:S + step + 1]
        for k in ("h", "conv"):
            _close(st_t[k], st_r[k])
        out_r, st_r = r_rglru_decode(p, jnp.asarray(xs), st_r)
        out_t, st_t = T_rglru.rglru_decode(m, _t(xs), st_t)
        _close(out_t, out_r)


def test_linear_scan_equals_loop():
    """The scan is the recurrence h_t = a_t h_{t-1} + b_t (float32 loop)."""
    rng = _rng(13)
    a = rng.uniform(0.0, 1.0, (2, 37, 5)).astype(np.float32)
    b = _normal(rng, 2, 37, 5)
    h = np.zeros((2, 5), np.float32)
    want = []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _, got = T_rglru.linear_scan(_t(a), _t(b))
    _close(got, np.stack(want, axis=1))


# ---------------------------------------------------------------- SSD

SSD_CFG = SSMCfg(d_state=16, d_inner=64, head_dim=16, n_groups=2, chunk=8, d_conv=4)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan(g):
    """S = 23: not a multiple of the chunk (8); with a start state."""
    rng = _rng(14)
    b, s, h, pd, n = 2, 23, 4, 8, 16
    x = _normal(rng, b, s, h, pd)
    dt = np.abs(_normal(rng, b, s, h)) * 0.5
    A = -np.abs(_normal(rng, h))
    B, C = _normal(rng, b, s, g, n), _normal(rng, b, s, g, n)
    h0 = _normal(rng, b, h, pd, n)
    yr, fr = r_ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)), 8, initial_state=jnp.asarray(h0))
    yt, ft = T_ssd.ssd_scan(*map(_t, (x, dt, A, B, C)), 8, initial_state=_t(h0))
    # sums over up to 23 steps of products of unit-scale normals: 1e-5 of
    # values up to ~50
    _close(yt, yr, rtol=1e-5, atol=5e-5)
    _close(ft, fr, rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("ssm", [SSD_CFG, dataclasses.replace(SSD_CFG, n_groups=1)])
def test_ssd_train_state_and_decode(ssm):
    p = R_ssd.init_ssd(KEY, 32, ssm)
    rng = _rng(15)
    p = dict(p, A_log=jnp.asarray(_normal(rng, ssm.n_heads) * 0.5),
             dt_bias=jnp.asarray(_normal(rng, ssm.n_heads) * 0.5),
             gate_norm=jnp.asarray(_normal(rng, ssm.d_inner) * 0.1))
    m = _load(T_ssd.SSD(32, ssm, device="meta"), p)
    S = 19  # not a multiple of the chunk (8)
    x = _normal(rng, 2, S + 2, 32)
    out_r, st_r = r_ssd_train(p, jnp.asarray(x[:, :S]), ssm, return_state=True)
    out_t, st_t = T_ssd.ssd_train(m, _t(x[:, :S]), ssm, return_state=True)
    _close(out_t, out_r, rtol=1e-5, atol=2e-5)
    for step in range(2):
        for k in ("state", "conv"):
            _close(st_t[k], st_r[k], rtol=1e-5, atol=2e-5)
        xs = x[:, S + step:S + step + 1]
        out_r, st_r = r_ssd_decode(p, jnp.asarray(xs), st_r, ssm)
        out_t, st_t = T_ssd.ssd_decode(m, _t(xs), st_t, ssm)
        _close(out_t, out_r, rtol=1e-5, atol=2e-5)
    z_r, z_t = R_ssd.init_ssd_state(3, ssm), T_ssd.init_ssd_state(3, ssm)
    assert {k: v.shape for k, v in z_r.items()} == {k: tuple(v.shape) for k, v in z_t.items()}
