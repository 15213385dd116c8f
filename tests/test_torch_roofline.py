"""The port's roofline modules (``repro_torch.roofline``) against the
reference's (``repro.roofline``), number for number.

* ``analytic_work``: every architecture x shape x ``n_devices`` in {1, 4,
  256, 512}, and the ten reduced configs, relative 1e-12 on the flops, the
  bytes and every detail term.
* ``collective_seconds`` and ``roofline_terms``: the same ops, on the
  reference's ``V5E`` values built into the port's ``HW`` here (the port
  holds no TPU constant), and on the port's ``H100``, whose numbers are
  NVIDIA's data sheet's. The reference's HLO parser has no counterpart:
  torch emits no HLO, and the port's dry run lists its step's copies.
"""

import dataclasses

import pytest

from repro.configs import ARCHS as REF_ARCHS, SHAPES as REF_SHAPES, reduced as ref_reduced
from repro.roofline import analysis as ref_analysis
from repro.roofline.analytic import analytic_work as ref_analytic_work
from repro.roofline.hw import V5E
from repro_torch.configs import ARCHS, SHAPES, reduced
from repro_torch.roofline import analysis
from repro_torch.roofline.analytic import analytic_work
from repro_torch.roofline.hw import H100, HW

N_DEVICES = (1, 4, 256, 512)
PORT_V5E = HW(**dataclasses.asdict(V5E))


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b))


def _same_work(got, want, what) -> None:
    assert _close(got.flops, want.flops), (what, got.flops, want.flops)
    assert _close(got.hbm_bytes, want.hbm_bytes), (what, got.hbm_bytes, want.hbm_bytes)
    assert sorted(got.detail) == sorted(want.detail), what
    for k, v in want.detail.items():
        assert _close(got.detail[k], v), (what, k, got.detail[k], v)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_analytic_work_matches_reference(name):
    for shape in sorted(SHAPES):
        for n in N_DEVICES:
            got = analytic_work(ARCHS[name], SHAPES[shape], n)
            _same_work(got, ref_analytic_work(REF_ARCHS[name], REF_SHAPES[shape], n),
                       (name, shape, n))
            assert got.flops > 0 and got.hbm_bytes > 0


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_analytic_work_matches_reference_reduced(name):
    for shape in sorted(SHAPES):
        for n in (1, 4):
            _same_work(analytic_work(reduced(ARCHS[name]), SHAPES[shape], n),
                       ref_analytic_work(ref_reduced(REF_ARCHS[name]), REF_SHAPES[shape], n),
                       (name, shape, n))


OPS = [("all-gather", "f32", (16, 64), 4, 1), ("all-reduce", "bf16", (8, 8), 8, 3),
       ("reduce-scatter", "bf16", (128, 4), 16, 1), ("all-to-all", "s32", (32,), 2, 5),
       ("collective-permute", "f32", (7, 3), 2, 15), ("all-reduce", "f32", (9,), 1, 1),
       ("all-gather", "u8", (), 4, 2)]


def _ops(mod):
    return [mod.CollectiveOp(k, d, s, g, trip_mult=t) for k, d, s, g, t in OPS]


@pytest.mark.parametrize("hw", ["v5e", "h100"])
def test_collective_seconds_matches_reference(hw):
    port_hw = PORT_V5E if hw == "v5e" else H100
    ref_hw = V5E if hw == "v5e" else ref_analysis.HW(
        **{f.name: getattr(H100, f.name) for f in dataclasses.fields(ref_analysis.HW)})
    got = analysis.collective_seconds(_ops(analysis), port_hw)
    want = ref_analysis.collective_seconds(_ops(ref_analysis), ref_hw)
    assert got[1] == want[1] and _close(got[0], want[0]), (got, want)
    for op, rop in zip(_ops(analysis), _ops(ref_analysis)):
        assert op.bytes == rop.bytes
    assert got[0] > 0


def test_roofline_terms_match_reference():
    from repro.roofline.analytic import WorkModel as RefWork

    flops, nbytes = 7.0e11, 4.0e9
    got = analysis.roofline_terms(flops, nbytes, _ops(analysis), PORT_V5E,
                                  model_flops_per_dev=5e11)
    # the reference takes the flops and bytes from a WorkModel and its
    # collectives from HLO text only: give it none and add the same ops' time
    want = ref_analysis.roofline_terms({}, "", V5E, model_flops_per_dev=5e11,
                                       analytic=RefWork(flops, nbytes, {}))
    t_coll, wire = ref_analysis.collective_seconds(_ops(ref_analysis), V5E)
    want.t_collective, want.collective_bytes_per_dev = t_coll, wire
    want.n_collectives = len(OPS)
    g, w = got.to_dict(), want.to_dict()
    # the port keeps every key but the compiler's raw cost analysis
    assert sorted(g) == sorted(k for k in w if not k.startswith("raw_cost_analysis"))
    for k, v in g.items():
        assert v == w[k] if isinstance(v, str) else _close(v, w[k]), (k, v, w[k])
    assert got.step_time == want.step_time
    h = analysis.roofline_terms(flops, nbytes, [], H100)
    assert (h.t_compute, h.t_memory, h.t_collective) == (flops / H100.peak_bf16_flops,
                                                         nbytes / H100.hbm_bw, 0.0)
