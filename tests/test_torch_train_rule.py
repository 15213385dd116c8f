"""The rule that holds one train step of the port against another's
(the reference's, or the port's on another device); this module holds no
test and imports no JAX, so the card's tests use it too.

With ``cast_bf16`` each rank >= 2 leaf's gradient is rounded to bfloat16
(8 significant bits: one ulp is at most 2**-7 of the value). Where two
float32 gradients that agree to float noise straddle a rounding boundary,
they round to neighbouring bfloat16 values. A gradient may be a sum of
rounded terms (a tied embedding's gather and head, or micro-batches), each
of which may flip, so a flip is bounded by one ulp of the leaf's largest
term rather than of the entry. So the moments are held to 1e-4 of each
leaf's largest, except at no more than 0.1% of the entries, which may
differ by up to one bf16 ulp of the leaf's largest (m is linear in the
gradient; v, quadratic, two).

The parameters are held to 1e-6 after the update that the two sides' own
moments give: AdamW moves an entry by lr * m^/(sqrt(v^) + eps), which is
about lr * sign(g) wherever |g| is far above eps = 1e-8, but swings by up to
2 lr where a gradient at float noise (near eps, or in a leaf whose exact
gradient is zero, such as the key bias: a shift of every score of a query
cancels in the softmax) differs between the two. So each side's new
parameters minus the other's must equal -lr times the difference of their
Adam directions, computed from their moments (which the moment rule holds),
within 1e-6; the entries that differ by more than 1e-6 are counted, and
none may differ by more than 2 lr.
"""

from __future__ import annotations

import numpy as np
import torch

BF16_ULP = 2.0 ** -7
STEP_TOL = 1e-4  # of a leaf's largest |m| or |v|
FLIP_SHARE = 1e-3  # most entries that may take the one-ulp allowance


def _t(x) -> torch.Tensor:
    """A float32 CPU tensor of a tensor or array, cut from autograd."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu()
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def assert_moments_close(got: dict, want: dict, what: str, ulps: float,
                         fresh: dict | None = None) -> int:
    """Each leaf within ``STEP_TOL`` of its largest |want|, except at no more
    than ``FLIP_SHARE`` of the entries, which may differ by ``ulps`` bf16
    ulps of the largest term of this step's gradient more. ``fresh`` is that
    term, (1 - b1) g or (1 - b2) g^2, by default the whole moment (a first
    step). Returns the number of such entries."""
    flips = total = 0
    for name, w in want.items():
        w, g = _t(w), _t(got[name])
        assert g.shape == w.shape, name
        d = (g - w).abs()
        tol = STEP_TOL * w.abs().max()
        over = d > tol
        flips += int(over.sum())
        total += d.numel()
        base = w if fresh is None else _t(fresh[name])
        bad = over & (d > ulps * BF16_ULP * base.abs().max() + tol)
        assert not bad.any(), (f"{what} {name}: {int(bad.sum())} entries beyond {ulps} bf16 "
                               f"ulp of the leaf's largest, max diff {float(d.max()):.3g}")
    assert flips <= FLIP_SHARE * total, f"{what}: {flips} of {total} entries need the ulp allowance"
    return flips


def _direction(m, v, step: int, b1: float, b2: float, eps: float) -> torch.Tensor:
    """AdamW's step direction m^ / (sqrt(v^) + eps), in float64."""
    m, v = _t(m).double(), _t(v).double()
    return (m / (1 - b1 ** step)) / ((v / (1 - b2 ** step)).sqrt() + eps)


def assert_params_close(got: dict, want: dict, got_opt: dict, want_opt: dict, lr: float,
                        step: int, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8) -> int:
    """``got`` and ``want`` are the new parameters of two steps from the same
    parameters; ``*_opt`` their new moments (``{"m", "v"}`` by name). Returns
    the count of entries that differ by more than 1e-6."""
    moved = 0
    for name, w in want.items():
        w, g = _t(w).double(), _t(got[name]).double()
        d = g - w
        pred = -lr * (_direction(got_opt["m"][name], got_opt["v"][name], step, b1, b2, eps)
                      - _direction(want_opt["m"][name], want_opt["v"][name], step, b1, b2, eps))
        off = (d - pred).abs()
        assert not (off > 1e-6).any(), \
            f"param {name}: {float(off.max()):.3g} beyond the moments' own update"
        assert not (d.abs() > 2 * lr).any(), f"param {name}: beyond 2 lr"
        moved += int((d.abs() > 1e-6).sum())
    return moved
