"""The chunked cross-entropy against the reference's ``chunked_xent``, and
the SSD layer's gradient at a long chunk.

``chunked_xent``: tied and untied heads, S a multiple of the chunk or not
(padded with ignored labels), ignored labels (-1) inside a chunk, a chunk
with no valid label and a batch with none (the mean over max(count, 1)), and
the text positions of a VLM's hidden states (a slice after the patches).
The loss within 1e-5; the gradients with respect to h and to the head
within 1e-5 of each one's largest |g|.

The SSD: the reduced mamba2-370m at its published chunk of 256 with
B = 2, S = 256. Above the diagonal of a chunk the log-decay difference is
positive; its exp overflows at that length, and masking the exp after the
fact gives the gradient 0 * inf = NaN (the reference's
``models/layers/ssd.py`` does so). The port masks the difference before the
exp: its gradient must be finite and equal, within 1e-4 of each leaf's
largest |g|, to the reference's at chunk 8, which computes the same
function without the overflow."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.embeddings import chunked_xent as ref_chunked_xent
from repro_torch.models.layers.embeddings import Embed, chunked_xent
from repro_torch.models.zoo import build as port_build
from test_torch_lm_helpers import pair
from test_torch_train_helpers import to_port, train_batches

TOL = 1e-5
V, D = 48, 16


def _case(seed, b, s, tie, ignore):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((V, D)).astype(np.float32) * 0.3
    head = rng.standard_normal((D, V)).astype(np.float32) * 0.3
    h = rng.standard_normal((b, s, D)).astype(np.float32)
    labels = rng.integers(0, V, (b, s))
    if ignore == "some":
        labels[0, :5] = -1
        labels[-1, -2:] = -1
    elif ignore == "chunk":
        labels[:, :8] = -1  # the first chunk has no valid label
    elif ignore == "all":
        labels[:] = -1
    p = {"embedding": emb} if tie else {"embedding": emb, "lm_head": head}
    return p, h, labels


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("s,chunk,ignore", [(20, 8, "some"), (16, 8, "none"), (5, 512, "some"),
                                            (24, 8, "chunk"), (12, 8, "all"), (1, 4, "none")])
def test_chunked_xent_matches_reference(s, chunk, ignore, tie):
    p, h, labels = _case(s + chunk, 3, s, tie, ignore)
    rp = jax.tree.map(jnp.asarray, p)
    r_loss, (r_gp, r_gh) = jax.value_and_grad(
        lambda p_, h_: ref_chunked_xent(p_, h_, jnp.asarray(labels, jnp.int32), None, chunk),
        argnums=(0, 1))(rp, jnp.asarray(h))
    e = Embed(V, D, tie)
    with torch.no_grad():
        e.embedding.copy_(torch.from_numpy(p["embedding"]))
        if not tie:
            e.lm_head.copy_(torch.from_numpy(p["lm_head"]))
    th = torch.from_numpy(h).requires_grad_(True)
    loss = chunked_xent(e, th, torch.from_numpy(labels), chunk=chunk)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(r_loss)) <= TOL
    if ignore == "all":
        assert float(loss) == 0.0
    head = (e.embedding.grad, r_gp["embedding"]) if tie else (e.lm_head.grad, r_gp["lm_head"])
    if not tie:  # the untied head does not read the embedding
        assert e.embedding.grad is None and not np.asarray(r_gp["embedding"]).any()
    for got, want in ((th.grad, r_gh), head):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got.numpy() - want).max()) <= TOL * scale


def test_chunked_xent_vlm_text_positions():
    """The loss over a VLM's text positions: the hidden states after the
    patches, a strided view of the full sequence."""
    n_patches = 4
    p, h, labels = _case(9, 2, 20 + n_patches, True, "some")
    labels = labels[:, n_patches:]
    want = ref_chunked_xent(jax.tree.map(jnp.asarray, p), jnp.asarray(h)[:, n_patches:],
                            jnp.asarray(labels, jnp.int32), None, 8)
    e = Embed(V, D, True)
    with torch.no_grad():
        e.embedding.copy_(torch.from_numpy(p["embedding"]))
    with torch.no_grad():
        got = chunked_xent(e, torch.from_numpy(h)[:, n_patches:], torch.from_numpy(labels),
                           chunk=8)
    assert abs(float(got) - float(want)) <= TOL


def test_ssd_gradient_finite_at_full_chunk():
    rm, params, tm, net = pair("mamba2-370m")
    assert rm.cfg.ssm.chunk == 8
    rb, tb = train_batches(rm.cfg, 11, 2, 256)
    want = to_port(jax.jit(jax.grad(lambda p, b: rm.train_loss(p, None, b)))(params, rb), tm.cfg)
    cfg256 = dataclasses.replace(tm.cfg, ssm=dataclasses.replace(tm.cfg.ssm, chunk=256))
    tm256 = port_build(cfg256)
    net256 = tm256.load({k: v.detach().clone() for k, v in net.state_dict().items()})
    loss = tm256.train_loss(net256, tb)
    loss.backward()
    for n, p in net256.named_parameters():
        assert torch.isfinite(p.grad).all(), n
        scale = float(want[n].abs().max())
        err = float((p.grad - want[n]).abs().max())
        assert err <= 1e-4 * scale, f"{n}: {err:.3g} > 1e-4 * {scale:.3g}"
