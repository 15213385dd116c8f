"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA. It needs nothing else of the
machine: the kernels build from the sources in the checkout into
``build/kernels/``. Phases, one line each (and a few detail lines):

1. device: the card's name and power limit (``nvidia-smi``), then the kernel
   build with its register and shared-memory use (``-Xptxas -v``);
2. kernels: every CUDA kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes and at edge cases, then timed with
   CUDA events beside its memory bound and its plain version;
3. main path: a cold mine of the paper's Poker-hand shape (1,000,000 rows,
   10 columns, tau=1, kmax=4, default settings) with ``engine="cuda"``, then
   with ``engine="torch"`` on the same card; itemsets and per-level stats
   must be identical, the fused kernels must have launched, and a small
   input is checked against the numpy engine and the brute-force oracle;
4. host-classified path: a Connect-4-shaped mine (67,557 x 43, tau=1,
   kmax=3, ``fused_classify=False``), ``cuda`` against ``torch``; the unfused
   kernels must have launched.

It prints a JSON line of per-kernel numbers and, last, the JSON status line.
Any mismatch, build failure or missing card exits non-zero before that line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "src/repro_torch/kernels/intersect/csrc/intersect.cu"
# Pallas kernels replaced, by wrapper name: (file:line of the TPU kernel,
# writes the child, classifies)
KERNELS = {
    "intersect_classify_write_indexed": ("src/repro/kernels/intersect/intersect.py:330", True, True),
    "intersect_classify_count_indexed": ("src/repro/kernels/intersect/intersect.py:388", False, True),
    "intersect_write_indexed": ("src/repro/kernels/intersect/intersect.py:101", True, False),
    "intersect_count_indexed": ("src/repro/kernels/intersect/intersect.py:148", False, False),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores (data sheet)
OPS_PER_WORD = 3  # AND, popcount, add per word of each pair


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def stat_tuple(s):
    return (s.k, s.candidates, s.support_pruned, s.bound_pruned,
            s.intersections, s.emitted, s.skipped_absent_uniform, s.stored)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, after two warm-up
    runs, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 -----------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not read"
    print(card, flush=True)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    for name in _build.SOURCES:
        for line in _build.BUILD_LOGS[name].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")
    print(f"phase device: ok card={card!r} torch={torch.__version__} cuda={torch.version.cuda} "
          f"build_s={build_s:.1f}", flush=True)
    return card


# -- phase 2 -----------------------------------------------------------------


def _kernel_inputs(t: int, w: int, m: int, seed: int, device):
    """(t, w) int32 words, (m, 2) prefix-join-shaped pairs and popcounts.

    Rows 0-7 are crafted so every class occurs: 0 is empty, 1 all ones
    (every bit, sign bit included), 2 == 3, 4 has three bits, 5 shares two
    of them; the rest are random words. Pairs are i-sorted with j a little
    after i, as the candidate generator emits them, plus self-pairs."""
    g = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(-(2**31), 2**31 - 1, (t, w), dtype=torch.int32, device=device, generator=g)
    special = np.zeros((8, w), dtype=np.uint32)
    special[1] = 0xFFFFFFFF
    special[2] = special[3] = np.random.default_rng(seed).integers(0, 2**32, w, dtype=np.uint32)
    special[4, 0] = 0b10110
    special[5, 0] = 0b00110
    special[5, w - 1] = 0x80000001
    bits[:8] = torch.from_numpy(special.view(np.int32)).to(device)
    i = torch.sort(torch.randint(0, t - 1, (m,), device=device, generator=g)).values
    j = torch.clamp(i + 1 + torch.randint(0, 40, (m,), device=device, generator=g), max=t - 1)
    pairs = torch.stack([i, j], dim=1).to(torch.int32)
    fixed = torch.tensor([[0, 9], [1, 1], [1, 9], [2, 3], [4, 5], [5, 4], [9, 9], [1, 4]],
                         dtype=torch.int32, device=device)
    pairs[: min(m, len(fixed))] = fixed[: min(m, len(fixed))]
    from repro_torch.kernels.intersect import popcount_rows_ref

    pc = torch.cat([popcount_rows_ref(chunk) for chunk in bits.split(4096)])
    return bits, pairs.contiguous(), pc


def _max_abs_err(got, want) -> int:
    """Largest absolute difference over all outputs, words read unsigned."""
    err = 0
    for a, b in zip(got, want):
        a = a.to(torch.int64) & 0xFFFFFFFF
        b = b.to(torch.int64) & 0xFFFFFFFF
        if a.shape != b.shape:
            fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a - b).abs().max().item()))
    return err


def _call(name, bits, pairs, pc, tau):
    from repro_torch.kernels import intersect as K
    from repro_torch.kernels.intersect import ref as R

    _, write, classify = KERNELS[name]
    kern = getattr(K, name)
    plain = {
        "intersect_classify_write_indexed": R.intersect_classify_ref,
        "intersect_classify_count_indexed": R.intersect_classify_count_ref,
        "intersect_write_indexed": lambda b, p, c, t: R.intersect_pairs_ref(b, p),
        "intersect_count_indexed": lambda b, p, c, t: (R.intersect_count_ref(b, p),),
    }[name]
    if classify:
        run = lambda: kern(bits, pairs, pc, tau)
    else:
        run = lambda: kern(bits, pairs)
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
    return (lambda: as_tuple(run())), (lambda: as_tuple(plain(bits, pairs, pc, tau)))


def _bound_ms(name, bits, pairs) -> tuple[float, str]:
    _, write, classify = KERNELS[name]
    m, w = pairs.shape[0], bits.shape[1]
    unique_rows = int(torch.unique(pairs).numel())
    read = unique_rows * w * 4 + m * 8 + (unique_rows * 4 if classify else 0)
    written = (m * w * 4 if write else 0) + m * 4 + (m * 4 if classify else 0)
    bytes_s = (read + written) / HBM_BYTES_PER_S
    ops_s = OPS_PER_WORD * m * w / INT32_OPS_PER_S
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s else "operations")


def phase_kernels(device, n_words: int, batch_bucket: int):
    from repro_torch.core.bitops import padded_words

    w_pad = padded_words(n_words)
    # main-path shapes: the write kernels read a level-2-sized parent table,
    # the count kernels a level-3-sized one
    parents = {True: 4096, False: 65_536}
    checks = 0
    for write in (True, False):
        big = _kernel_inputs(parents[write], w_pad, batch_bucket, seed=1, device=device)
        unaligned = _kernel_inputs(257, n_words, 1024, seed=2, device=device)
        small = [_kernel_inputs(16, w, m, seed=3 + w, device=device) for w in (1, 3, 33) for m in (1, 7)]
        for name, (_, kw, _) in KERNELS.items():
            if kw != write:
                continue
            for bits, pairs, pc in [big, unaligned, *small]:
                for tau in (0, 1, 5):
                    for mm in sorted({0, 1, pairs.shape[0]}):
                        kern, plain = _call(name, bits, pairs[:mm].contiguous(), pc, tau)
                        got, want = kern(), plain()
                        torch.cuda.synchronize()
                        if len(got) != len(want):
                            fail(f"{name}: {len(got)} outputs, plain gives {len(want)}")
                        err = _max_abs_err(got, want)
                        if err:
                            fail(f"{name} W={bits.shape[1]} M={mm} tau={tau}: max_abs_err={err}")
                        checks += 1
        del big, unaligned, small
        torch.cuda.empty_cache()

    rows = {}
    for name, (_, write, classify) in KERNELS.items():
        bits, pairs, pc = _kernel_inputs(parents[write], w_pad, batch_bucket, seed=11, device=device)
        kern, plain = _call(name, bits, pairs, pc, 1)
        err = _max_abs_err(kern(), plain())
        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 5)
        bound_ms, bound_by = _bound_ms(name, bits, pairs)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "t": parents[write], "W": w_pad, "M": batch_bucket}
        del bits, pairs, pc
        torch.cuda.empty_cache()
    print("phase kernels: ok " + json.dumps({"checks": checks, "kernels": [
        {"name": n, "kernel_ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "shape": {"t": r["t"], "W": r["W"], "M": r["M"]}}
        for n, r in rows.items()]}), flush=True)
    return rows


# -- phases 3 and 4 ---------------------------------------------------------


def _mine_pair(prep, cfg, label: str, kernels: tuple[str, ...]):
    """Mine ``prep`` with the cuda engine, then the torch engine; both must
    agree, and each kernel in ``kernels`` must have launched in the cuda run."""
    from repro_torch.core.kyiv import mine_preprocessed
    from repro_torch.kernels.intersect import LAUNCHES, reset_launches

    runs = {}
    launches = None
    for engine in ("cuda", "torch"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if engine == "cuda":
            reset_launches()
        t0 = time.perf_counter()
        res = mine_preprocessed(prep, dataclasses.replace(cfg, engine=engine))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if engine == "cuda":
            launches = dict(LAUNCHES)
        runs[engine] = (res, wall, torch.cuda.max_memory_allocated())
    (cu, cu_wall, cu_peak), (pl, pl_wall, pl_peak) = runs["cuda"], runs["torch"]
    if sorted(cu.itemsets) != sorted(pl.itemsets):
        fail(f"{label}: cuda and torch itemsets differ ({len(cu.itemsets)} vs {len(pl.itemsets)})")
    if list(map(stat_tuple, cu.stats)) != list(map(stat_tuple, pl.stats)):
        fail(f"{label}: per-level stats differ: {list(map(stat_tuple, cu.stats))} vs "
             f"{list(map(stat_tuple, pl.stats))}")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        fail(f"{label}: the main path never launched {missing} (launches {launches})")
    for engine, res in (("cuda", cu), ("torch", pl)):
        for s in res.stats:
            print(f"  {label} {engine} k={s.k} {stat_tuple(s)} candidates_s={s.time_candidates:.4f} "
                  f"intersect_s={s.time_intersect:.4f} classify_s={s.time_classify:.4f} "
                  f"total_s={s.time_total:.4f}")
    summary = {
        "emitted": len(cu.itemsets),
        "cuda_wall_s": cu_wall, "torch_wall_s": pl_wall,
        "cuda_peak_bytes": cu_peak, "torch_peak_bytes": pl_peak,
        "peak_level_bytes": cu.peak_level_bytes,
        "launches": {k: v for k, v in launches.items() if v},
    }
    return summary, launches


def phase_main(device):
    from repro_torch.core import KyivConfig, brute_force_minimal_infrequent, mine, prepare
    from repro_torch.data.synth import poker_like

    # a small input first, held against the numpy engine and the oracle
    small = poker_like(n=3000, seed=1)[:, :6]
    got = mine(small, KyivConfig(tau=1, kmax=3, engine="cuda", device=str(device)))
    ref = mine(small, KyivConfig(tau=1, kmax=3, engine="numpy"))
    if sorted(got.itemsets) != sorted(ref.itemsets) or list(map(stat_tuple, got.stats)) != list(
        map(stat_tuple, ref.stats)
    ):
        fail("small poker: cuda engine differs from the numpy engine")
    tiny = poker_like(n=200, seed=2)[:, :4]
    if mine(tiny, KyivConfig(tau=1, kmax=3, engine="cuda", device=str(device))).canonical_set() != \
            brute_force_minimal_infrequent(tiny, 1, 3):
        fail("tiny poker: cuda engine differs from the brute-force oracle")

    t0 = time.perf_counter()
    D = poker_like(n=1_000_000, m=10, seed=0)
    cfg = KyivConfig(tau=1, kmax=4, engine="cuda", device=str(device))
    prep = prepare(D, cfg)
    prep_s = time.perf_counter() - t0
    summary, launches = _mine_pair(
        prep, cfg, "poker",
        ("intersect_classify_write_indexed", "intersect_classify_count_indexed"),
    )
    print("phase main: ok " + json.dumps({"dataset": "poker_like(n=1000000, m=10, seed=0)",
                                          "W": prep.l_bits.shape[1], "n_l": prep.n_l,
                                          "tau": 1, "kmax": 4, "prepare_s": prep_s, **summary}),
          flush=True)
    return launches


def phase_host_classified(device):
    from repro_torch.core import KyivConfig, prepare
    from repro_torch.data.synth import connect_like

    D = connect_like()
    cfg = KyivConfig(tau=1, kmax=3, engine="cuda", device=str(device), fused_classify=False)
    prep = prepare(D, cfg)
    summary, launches = _mine_pair(
        prep, cfg, "connect", ("intersect_write_indexed", "intersect_count_indexed")
    )
    print("phase host-classified: ok " + json.dumps({"dataset": "connect_like(n=67557, m=43)",
                                                     "W": prep.l_bits.shape[1], "n_l": prep.n_l,
                                                     "tau": 1, "kmax": 3, **summary}), flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (the port must be in this checkout)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    phase_device()
    n_words = (1_000_000 + 31) // 32  # the Poker-hand table's bitset width
    batch_cap = max(4096, (1 << 28) // n_words)  # core.frontier.mine_levels' batch cap
    from repro_torch.kernels.intersect import next_bucket

    timing = phase_kernels(device, n_words, next_bucket(batch_cap))
    launches = phase_main(device)
    launches.update({k: v for k, v in phase_host_classified(device).items()
                     if k in ("intersect_write_indexed", "intersect_count_indexed")})

    kernels = []
    for name, (replaces, _, _) in KERNELS.items():
        r = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    print(f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
