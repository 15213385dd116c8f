"""The LM port on a card: all ten reduced architectures, float32, against the
port on the CPU with the same weights (prefill, then 8 decode steps, logits
and every cache leaf at rtol = atol = 1e-4: float32 sums in other orders),
and the serve entry point on the card. TF32 stays off (PyTorch's default;
the port never enables it). Marked ``gpu``; every test skips where torch
sees no CUDA card (run them there with
``python -m pytest -m gpu tests/test_torch_gpu_lm.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.serve import make_batch, serve
from repro_torch.models.zoo import build
from repro_torch.serving.engine import prefill_then_decode

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS = 2, 20, 8  # S over the reduced window (16): local layers keep rings


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", 0)


def _leaves(cache):
    if isinstance(cache, dict):
        return _leaves(cache["self"]) + _leaves(cache["cross"])
    return [(i, k, v.float().cpu()) for i, st in enumerate(cache) for k, v in sorted(st.items())]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_reduced_arch_on_card_equals_cpu(cuda, name):
    cfg = reduced(ARCHS[name])
    model = build(cfg)
    cpu_net = model.init(torch.Generator().manual_seed(0))
    card_net = model.load({k: v.to(cuda) for k, v in cpu_net.state_dict().items()})
    batch = make_batch(cfg, np.random.default_rng(1), B, S + STEPS)
    want, want_cache = prefill_then_decode(model, cpu_net, batch, S, STEPS)
    got, got_cache = prefill_then_decode(model, card_net, batch, S, STEPS)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    for (i, k, g), (_, _, w) in zip(_leaves(got_cache), _leaves(want_cache), strict=True):
        torch.testing.assert_close(g, w, **TOL, msg=f"layer {i} {k}")


def test_serve_on_card_repeats(cuda):
    """The entry point on the card (reduced, so float32): two runs of one
    seed give the same tokens."""
    kw = dict(reduced=True, batch=3, prompt_len=20, max_new=6)
    a, b = serve("gemma3-4b", **kw), serve("gemma3-4b", **kw)
    assert a["device"] == "cuda" and a["peak_bytes"] > 0
    assert a["tokens"] == b["tokens"] and np.shape(a["tokens"]) == (3, 6)
