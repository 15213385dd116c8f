"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA. It needs nothing else of the
machine: the kernels build from the sources in the checkout into
``build/kernels/``. Phases, one line each (and a few detail lines):

1. device: the card's name and power limit (``nvidia-smi``), then the kernel
   build with its register and shared-memory use (``-Xptxas -v``), the rate
   probes' instruction counts (``cuobjdump -sass``) and the card's measured
   logic, popcount and b1 ``mma`` rates beside the documented ones;
2. kernels: every CUDA kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes and at edge cases, then timed with
   CUDA events beside its memory bound and its plain version (the gathered
   kernels also beside the torch gather that feeds them); the donating
   kernel must write its child over its first operand;
3. main path: a cold mine of the paper's Poker-hand shape (1,000,000 rows,
   10 columns, tau=1, kmax=4, default settings) with ``engine="cuda"``, then
   with ``engine="torch"`` on the same card; itemsets and per-level stats
   must be identical, the fused kernels must have launched, and a small
   input is checked against the numpy engine and the brute-force oracle;
4. host-classified path: a Connect-4-shaped mine (67,557 x 43, tau=1,
   kmax=3, ``fused_classify=False``), ``cuda`` against ``torch``; the unfused
   kernels must have launched;
5. gathered path (``indexed_kernel=False``): the Poker-hand mine of phase 3
   (the donating fused write kernel and the fused count kernel), the
   Connect-4 mine of phase 4 (the unfused gathered kernels) and a fused
   Connect-4 mine that does not donate (the non-donating fused write
   kernel), each ``cuda`` against ``torch`` and against the indexed mine;
6. checkpoint: the port's CLI mines a 100,000-row Poker-hand table with
   ``--ckpt-dir``; the run is stopped after level 3 (level 4's checkpoint is
   removed), restored from disk and resumed, and must equal the
   uninterrupted mine;
7. privacy: the exposed table (``exposed_dataset``, 500,000 x 6, tau=1,
   kmax=3; cut from 1,000,000 rows, whose numpy-engine mine alone takes
   over a minute of host time, PERF.md) mined with ``engine="cuda"``,
   ``"torch"`` and ``"numpy"`` (all equal), its quasi-identifier report and
   record-risk profile through the coverage kernels (equal to the torch and
   host placements' profiles; its sparse QIs take the anchored kernel),
   the risk profile of phase 3's mine (QIs of frequent items: the scanning
   kernel; equal to the host placement's), both kernels must have
   launched; then a verified anonymization plan of the 100,000-row table
   on the card;
8. coverage-kernel: both coverage kernels (scanning and anchored) against
   the plain versions on the card, bit for bit, over widths, set sizes,
   batch sizes, sparse and sign-bit rows and weights that overflow int32
   (640 checks), and against the numpy host engine on small inputs; the
   index of the 500k table built and timed; then timed at the privacy
   path's batch shape (W = 15,628, M = 8,192, K = 3) on real
   quasi-identifiers of phase 7 (sparse: both kernels) and on random rows
   (dense: the scanning kernel), by CUDA events over back-to-back calls
   and over the replay of a CUDA graph of 20 calls (the device alone);
9. tiled: the group-tiled count kernel against its plain version on the
   card, bit for bit, over block sizes, widths and group layouts (T from 1
   to a few thousand block pairs), then its path at full width: the level-3
   frontier of phase 3's table (66,810 rows in 3,066 prefix groups), from
   a second mine of phase 3's ``prep`` with an ``on_level_end`` hook, laid
   out group-aligned through ``build_group_tiles`` (bm = 8), counted by
   the kernel in one launch and mapped back by ``counts_from_tiles``; the
   counts of all within-group pairs must equal the pairwise count kernel's
   (``intersect_count_indexed``) and the plain version's, and the kernel is
   timed beside the pairwise kernel over the same pairs in the level
   pipeline's batches of 16,384.

Each kernel's ``bound_ms`` is the larger of its bytes over the memory rate
and the least time of its operations. Phase 1 measures the card's rates of
32-bit three-input logic (``lop3``), popcount and the binary tensor-core
product (``mma ... .b1 ... .and.popc``) with the probes of
``kernels/probe/csrc/rates.cu``. Logic operations are priced at the larger
of the measured rate and the documented 64 per clock per SM (CUDA C++
Programming Guide, arithmetic instruction throughput, compute capability
9.0) times the SMs and ``clocks.max.sm``; popcounts likewise at 16 per
clock per SM. A sum of popcounts of ANDs over words needs an AND per word
and a carry-save (Harley-Seal) sum of two logic operations per word, which
leaves one popcount per 16 words (the ALU route). The tiled count's 8 x 8
tiles are also an ``m8n8`` binary product, priced as bit products over the
faster measured b1 ``mma`` rate (the tensor route); its operations take the
faster of the two routes. The coverage kernels' operations are counted from
this run's data: the scan's loads and ANDs per (set, word) and 96 per
nonzero AND, the anchored walk's per (set, anchor word) and 3 per set bit.

It prints a JSON line of per-kernel numbers and, last, the JSON status line.
Any mismatch, build failure or missing card exits non-zero before that line.
"""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "src/repro_torch/kernels/intersect/csrc/intersect.cu"
COVERAGE = "coverage_accumulate_indexed"
ANCHORED = "coverage_accumulate_anchored"
COVERAGE_SOURCE = "src/repro_torch/kernels/coverage/csrc/coverage.cu"
COVERAGE_REPLACES = "src/repro/kernels/coverage/coverage.py:72"
PRIVACY_ROWS = 500_000
# Pallas kernels replaced, by wrapper name: (file:line of the TPU kernel,
# writes the child, classifies). The gathered wrappers (name ends in
# "_gathered" or "_gathered_donating") take pre-gathered operand rows.
_PALLAS = "src/repro/kernels/intersect/intersect.py"
KERNELS = {
    "intersect_classify_write_indexed": (f"{_PALLAS}:330", True, True),
    "intersect_classify_count_indexed": (f"{_PALLAS}:388", False, True),
    "intersect_write_indexed": (f"{_PALLAS}:101", True, False),
    "intersect_count_indexed": (f"{_PALLAS}:148", False, False),
    "intersect_classify_write_gathered": (f"{_PALLAS}:521", True, True),
    "intersect_classify_write_gathered_donating": (f"{_PALLAS}:529", True, True),
    "intersect_classify_count_gathered": (f"{_PALLAS}:537", False, True),
    "intersect_write_gathered": (f"{_PALLAS}:208", True, False),
    "intersect_count_gathered": (f"{_PALLAS}:244", False, False),
}
DONATING = "intersect_classify_write_gathered_donating"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
# The fewest operations a sum of popcounts of ANDs over words needs: the
# AND of each word, then a carry-save (Harley-Seal) tree of two 3-input
# logic operations per word that leaves one popcount per HARLEY_SEAL_WORDS
OPS_PER_WORD = 3  # AND and two carry-save operations per word of each pair
HARLEY_SEAL_WORDS = 16
# 32-bit logic operations and population counts issued per clock per SM at
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput table)
LOGIC_PER_CLOCK_PER_SM = 64
POPC_PER_CLOCK_PER_SM = 16
TILED = "intersect_count_tiled"
TILED_SOURCE = "src/repro_torch/kernels/intersect/csrc/tiled.cu"
TILED_REPLACES = "src/repro/kernels/intersect/tiled.py:57"
TILED_BM = 8  # the reference's default block_rows
PAIRWISE_BATCH = 16_384  # the level pipeline's bucket at the Poker-hand width


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def stat_tuple(s):
    return (s.k, s.candidates, s.support_pruned, s.bound_pruned,
            s.intersections, s.emitted, s.skipped_absent_uniform, s.stored)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, after ``warmup``
    runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` without the host's launch overhead:
    ``iters`` calls captured in one CUDA graph, replayed once to warm up,
    then once between CUDA events. ``fn`` must not synchronise."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del g
    return ms


# -- phase 1 -----------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not read"
    print(card, flush=True)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    for name in _build.SOURCES:
        for line in _build.BUILD_LOGS[name].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")
    _print_probe_sass(paths["probe"])
    rates = _rates()
    print(f"phase device: ok card={card!r} torch={torch.__version__} cuda={torch.version.cuda} "
          f"build_s={build_s:.1f} rates={json.dumps(rates)}", flush=True)
    return rates


def _print_probe_sass(lib: Path) -> None:
    """The probes' instruction counts from ``cuobjdump -sass``: the logic
    probe must be LOP3s, the mma probes BMMAs (nothing folded away)."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        print("  probe sass: cuobjdump not found", flush=True)
        return
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    fn, counts = None, {}
    for line in out.stdout.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and m:
            op = m.group(1)  # BMMA keeps its shape and operation, e.g. BMMA.88128.AND.POPC
            key = op if op.startswith("BMMA") else op.split(".")[0]
            if key.split(".")[0] in ("LOP3", "POPC", "BMMA"):
                counts[fn][key] = counts[fn].get(key, 0) + 1
    for fn, c in counts.items():
        print(f"  probe sass {fn}: {c}", flush=True)


def _rates() -> dict:
    """The card's measured rates (the probes) and the documented ones (per
    clock per SM x SMs x the maximum SM clock that ``nvidia-smi`` reports),
    and the rates the bounds use: logic and popcounts at the larger of the
    two, the b1 product at the faster measured shape."""
    from repro_torch.kernels.probe import measure_rates

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    try:
        mhz = float(smi.stdout.strip().splitlines()[0])
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no SM clock: {smi.stdout!r} {smi.stderr!r}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_clock = sms * mhz * 1e6
    measured = measure_rates(torch.device("cuda", 0))
    for kind, r in measured.items():
        print(f"  rate {kind}: {r['ops_per_s']:.6g}/s = {r['ops_per_s'] / per_clock:.2f}/clock/SM "
              f"({r['ops']:.6g} in {r['ms']:.3f} ms)", flush=True)
    print(f"  documented: logic {LOGIC_PER_CLOCK_PER_SM}/clock/SM, popcount "
          f"{POPC_PER_CLOCK_PER_SM}/clock/SM; x {sms} SMs x {mhz:.0f} MHz", flush=True)
    got = {k: r["ops_per_s"] for k, r in measured.items()}
    return {
        "sms": sms, "clocks_max_sm_mhz": mhz,
        "measured_per_s": got,
        "measured_per_clock_per_sm": {k: v / per_clock for k, v in got.items()},
        "logic_per_s": max(got["lop3"], LOGIC_PER_CLOCK_PER_SM * per_clock),
        "popc_per_s": max(got["popc"], POPC_PER_CLOCK_PER_SM * per_clock),
        "bmma_per_s": max(got["mma_m8n8k128"], got["mma_m16n8k256"]),
    }


def _bound(nbytes: float, ops: float, popcounts: float, rates: dict,
           bit_products: float | None = None) -> dict:
    """The least time of a function: the larger of its bytes over the memory
    rate and its operations' least time, the faster of the ALU route (the
    larger of its logic operations over the logic rate and its popcounts
    over theirs) and, where the function is a binary product, the tensor
    route (its bit products over the b1 ``mma`` rate). Each limit printed."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s, popc_s = ops / rates["logic_per_s"], popcounts / rates["popc_per_s"]
    alu_s = max(ops_s, popc_s)
    tensor_s = None if bit_products is None else bit_products / rates["bmma_per_s"]
    compute_s = alu_s if tensor_s is None else min(alu_s, tensor_s)
    return {"bound_ms": max(bytes_s, compute_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= compute_s else "operations",
            "bytes_ms": bytes_s * 1e3, "ops_ms": ops_s * 1e3, "popc_ms": popc_s * 1e3,
            "alu_ms": alu_s * 1e3, "tensor_ms": None if tensor_s is None else tensor_s * 1e3,
            "route": "alu" if tensor_s is None or alu_s <= tensor_s else "tensor"}


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


def _gathered(name: str) -> bool:
    return "_gathered" in name


def _gather(bits, pairs, pc):
    """The gathered kernels' operands, as the gathered dispatch builds them."""
    from repro_torch.kernels.intersect import ref as R

    return bits[pairs[:, 0]], bits[pairs[:, 1]], R.min_parent_ref(pc, pairs)


def _call(name, bits, pairs, pc, tau):
    """(kernel, plain) thunks of one wrapper on one input. A gathered wrapper
    runs on operands gathered here once; the donating one writes over its
    ``a``, and its plain version is the non-donating one."""
    from repro_torch.kernels import intersect as K
    from repro_torch.kernels.intersect import ref as R

    _, write, classify = KERNELS[name]
    kern = getattr(K, name)
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
    if _gathered(name):
        a, b, minp = _gather(bits, pairs, pc)
        plain = {
            "intersect_classify_write_gathered": R.intersect_classify_gathered_ref,
            DONATING: R.intersect_classify_gathered_ref,
            "intersect_classify_count_gathered": R.intersect_classify_count_gathered_ref,
            "intersect_write_gathered": lambda a, b, m, t: R.intersect_gathered_ref(a, b),
            "intersect_count_gathered": lambda a, b, m, t: (R.intersect_count_gathered_ref(a, b),),
        }[name]
        run = (lambda: kern(a, b, minp, tau)) if classify else (lambda: kern(a, b))
        return (lambda: as_tuple(run())), (lambda: as_tuple(plain(a, b, minp, tau)))
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
    return (lambda: as_tuple(run())), (lambda: as_tuple(plain(bits, pairs, pc, tau)))


def _check_donating(bits, pairs, pc, tau) -> int:
    """The donating kernel on a copy of ``a``: its child must be that copy,
    and equal the non-donating kernel's and plain version's outputs."""
    from repro_torch.kernels import intersect as K
    from repro_torch.kernels.intersect import ref as R

    a, b, minp = _gather(bits, pairs, pc)
    want = R.intersect_classify_gathered_ref(a, b, minp, tau)
    other = K.intersect_classify_write_gathered(a, b, minp, tau)
    a_own = a.clone()
    got = K.intersect_classify_write_gathered_donating(a_own, b, minp, tau)
    torch.cuda.synchronize()
    if got[0].data_ptr() != a_own.data_ptr():
        fail(f"{DONATING} W={bits.shape[1]} M={pairs.shape[0]}: the child is not written over a")
    if _max_abs_err(got, other):
        fail(f"{DONATING} W={bits.shape[1]} M={pairs.shape[0]} tau={tau}: "
             "differs from intersect_classify_write_gathered")
    return _max_abs_err(got, want)


def _bound_ms(name, bits, pairs, rates) -> dict:
    _, write, classify = KERNELS[name]
    m, w = pairs.shape[0], bits.shape[1]
    if _gathered(name):
        # both (M, W) operands read once, the child written once, 4 bytes of
        # count per pair, and minp read + class written when classifying
        read = 2 * m * w * 4 + (m * 4 if classify else 0)
    else:
        unique_rows = int(torch.unique(pairs).numel())
        read = unique_rows * w * 4 + m * 8 + (unique_rows * 4 if classify else 0)
    written = (m * w * 4 if write else 0) + m * 4 + (m * 4 if classify else 0)
    return _bound(read + written, OPS_PER_WORD * m * w, m * w / HARLEY_SEAL_WORDS, rates)


def phase_kernels(device, n_words: int, batch_bucket: int, rates: dict):
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
                        sub = pairs[:mm].contiguous()
                        if name == DONATING:
                            err = _check_donating(bits, sub, pc, tau)
                        else:
                            kern, plain = _call(name, bits, sub, pc, tau)
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
        extra = {}
        if _gathered(name):
            extra["gather_ms"] = time_ms(lambda: _gather(bits, pairs, pc), 20)
        kern, plain = _call(name, bits, pairs, pc, 1)
        if name == DONATING:
            err = _check_donating(bits, pairs, pc, 1)
        else:
            err = _max_abs_err(kern(), plain())
        # the donating kernel runs over its own output here: the same
        # bytes move on every launch
        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 5)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      **_bound_ms(name, bits, pairs, rates),
                      "t": parents[write], "W": w_pad, "M": batch_bucket, **extra}
        del bits, pairs, pc, kern, plain
        torch.cuda.empty_cache()
    print("phase kernels: ok " + json.dumps({"checks": checks, "kernels": [
        {"name": n, "kernel_ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "share": r["bound_ms"] / r["ms"],
         "bytes_ms": r["bytes_ms"], "ops_ms": r["ops_ms"], "popc_ms": r["popc_ms"],
         "route": r["route"],
         **({"gather_ms": r["gather_ms"]} if "gather_ms" in r else {}),
         "shape": {"t": r["t"], "W": r["W"], "M": r["M"]}}
        for n, r in rows.items()]}), flush=True)
    return rows


# -- phases 3 and 4 ---------------------------------------------------------


def _mine_pair(prep, cfg, label: str, kernels: tuple[str, ...], *, donate: bool | None = None):
    """Mine ``prep`` with the cuda engine, then the torch engine; both must
    agree, and each kernel in ``kernels`` must have launched in the cuda run.
    ``donate`` overrides the placement's choice of the donating kernel.
    Returns (summary, launches, the cuda run's result)."""
    from repro_torch.core import DevicePlacement
    from repro_torch.core.kyiv import mine_preprocessed
    from repro_torch.kernels.intersect import LAUNCHES, reset_launches

    runs = {}
    launches = None
    for engine in ("cuda", "torch"):
        run_cfg = dataclasses.replace(cfg, engine=engine)
        if donate is not None:
            placement = DevicePlacement(engine, device=cfg.device, indexed=cfg.indexed_kernel)
            placement.donate = donate
            run_cfg = dataclasses.replace(run_cfg, placement=placement)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if engine == "cuda":
            reset_launches()
        t0 = time.perf_counter()
        res = mine_preprocessed(prep, run_cfg)
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
    return summary, launches, cu


def _same_mine(got, want, label: str) -> None:
    """Itemsets, per-level stat tuples and level_bytes identical."""
    if sorted(got.itemsets) != sorted(want.itemsets):
        fail(f"{label}: itemsets differ ({len(got.itemsets)} vs {len(want.itemsets)})")
    if list(map(stat_tuple, got.stats)) != list(map(stat_tuple, want.stats)):
        fail(f"{label}: per-level stats differ: {list(map(stat_tuple, got.stats))} vs "
             f"{list(map(stat_tuple, want.stats))}")
    if [s.level_bytes for s in got.stats] != [s.level_bytes for s in want.stats]:
        fail(f"{label}: level_bytes differ")


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
    summary, launches, res = _mine_pair(
        prep, cfg, "poker",
        ("intersect_classify_write_indexed", "intersect_classify_count_indexed"),
    )
    print("phase main: ok " + json.dumps({"dataset": "poker_like(n=1000000, m=10, seed=0)",
                                          "W": prep.l_bits.shape[1], "n_l": prep.n_l,
                                          "tau": 1, "kmax": 4, "prepare_s": prep_s, **summary}),
          flush=True)
    return launches, prep, res


def phase_host_classified(device):
    from repro_torch.core import KyivConfig, prepare
    from repro_torch.data.synth import connect_like

    D = connect_like()
    cfg = KyivConfig(tau=1, kmax=3, engine="cuda", device=str(device), fused_classify=False)
    prep = prepare(D, cfg)
    summary, launches, res = _mine_pair(
        prep, cfg, "connect", ("intersect_write_indexed", "intersect_count_indexed")
    )
    print("phase host-classified: ok " + json.dumps({"dataset": "connect_like(n=67557, m=43)",
                                                     "W": prep.l_bits.shape[1], "n_l": prep.n_l,
                                                     "tau": 1, "kmax": 3, **summary}), flush=True)
    return launches, prep, res


# -- phases 5 and 6 ---------------------------------------------------------


def phase_gathered(device, poker, connect):
    """``indexed_kernel=False`` on the mines of phases 3 and 4; ``poker`` and
    ``connect`` are those phases' (prep, indexed cuda result)."""
    from repro_torch.core import KyivConfig

    dev = str(device)
    runs = [
        ("poker-gathered", poker, KyivConfig(tau=1, kmax=4, device=dev, indexed_kernel=False),
         (DONATING, "intersect_classify_count_gathered"), None),
        ("connect-gathered", connect,
         KyivConfig(tau=1, kmax=3, device=dev, fused_classify=False, indexed_kernel=False),
         ("intersect_write_gathered", "intersect_count_gathered"), None),
        # the placement donates on a card; this run keeps a separate child
        ("connect-gathered-fused", connect,
         KyivConfig(tau=1, kmax=3, device=dev, indexed_kernel=False),
         ("intersect_classify_write_gathered", "intersect_classify_count_gathered"), False),
    ]
    launches, out = {}, {}
    for label, (prep, indexed_res), cfg, kernels, donate in runs:
        summary, got, res = _mine_pair(prep, cfg, label, kernels, donate=donate)
        _same_mine(res, indexed_res, f"{label} against the indexed mine")
        launches.update({k: got[k] for k in kernels if k not in launches})
        out[label] = summary
    print("phase gathered: ok " + json.dumps(out), flush=True)
    return launches


def _resume_from_cli_checkpoint(ckpt_dir: Path, out_json: Path, prep, cfg):
    """The state of a CLI run stopped after level 3, rebuilt from its
    checkpoints (level 3's frontier, level 2's for the k_max bound lookups)
    and from the itemsets and stats the run had emitted by then."""
    from repro_torch.core import ItemsetIndex, Level, LevelStats, MiningState
    from repro_torch.distributed.checkpoint import CheckpointManager

    cm = CheckpointManager(str(ckpt_dir))
    if cm.steps() != [2, 3, 4]:
        fail(f"checkpoint: the CLI left steps {cm.steps()}, expected [2, 3, 4]")
    # the run stops after level 3's checkpoint: level 4's never reaches disk
    shutil.rmtree(ckpt_dir / f"ckpt_{4:010d}")
    tree, meta = cm.restore()
    if (meta["step"], meta["tau"], meta["kmax"], int(tree["next_k"])) != (3, cfg.tau, cfg.kmax, 4):
        fail(f"checkpoint: restored meta {meta} next_k {tree['next_k']}")
    parent, _ = cm.restore(step=2)
    done = json.loads(out_json.read_text())
    return MiningState(
        results=[(tuple(r["items"]), r["count"]) for r in done["itemsets"] if len(r["items"]) <= 3],
        stats=[LevelStats(**st) for st in done["stats"] if st["k"] <= 3],
        level=Level(k=3, itemsets=tree["itemsets"], counts=tree["counts"], bits=tree["bits"]),
        grandparent_index=ItemsetIndex(parent["itemsets"], parent["counts"], n_symbols=prep.n_l),
        next_k=int(tree["next_k"]),
    )


def phase_checkpoint(device):
    from repro_torch.core import KyivConfig, prepare
    from repro_torch.core.kyiv import mine_preprocessed
    from repro_torch.data.synth import poker_like
    from repro_torch.launch import mine as launch_mine

    n = 100_000
    work = ROOT / "build" / "smoke_checkpoint"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        launch_mine.main(["--dataset", "poker", "--n", str(n), "--tau", "1", "--kmax", "4",
                          "--engine", "cuda", "--device", str(device),
                          "--ckpt-dir", str(work / "ckpt"), "--out", str(work / "out.json")])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cfg = KyivConfig(tau=1, kmax=4, device=str(device))
        prep = prepare(poker_like(n=n, seed=0), cfg)
        full = mine_preprocessed(prep, cfg)
        done = json.loads((work / "out.json").read_text())
        if sorted((tuple(r["items"]), r["count"]) for r in done["itemsets"]) != sorted(full.itemsets):
            fail("checkpoint: the CLI's mine differs from the uninterrupted mine")
        state = _resume_from_cli_checkpoint(work / "ckpt", work / "out.json", prep, cfg)
        t0 = time.perf_counter()
        resumed = mine_preprocessed(prep, cfg, resume_state=state)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        _same_mine(resumed, full, "checkpoint: resumed after level 3")
        ckpt_bytes = sum(f.stat().st_size for f in (work / "ckpt").rglob("*") if f.is_file())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("phase checkpoint: ok " + json.dumps({
        "dataset": f"poker_like(n={n}, m=10, seed=0)", "tau": 1, "kmax": 4,
        "emitted": len(full.itemsets), "cli_with_checkpoints_s": cli_s,
        "uninterrupted_s": full.wall_time, "resume_s": resume_s, "checkpoint_bytes": ckpt_bytes,
    }), flush=True)


# -- phases 7 and 8 ---------------------------------------------------------


def _same_profile(got, want, label: str) -> None:
    for name in ("counts_by_size", "qi_count", "min_qi_size", "risk"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            fail(f"{label}: {name} differs")


def phase_privacy(device, poker_res):
    """The privacy path on the exposed table: the mine on three engines, the
    report and risk profile through the coverage kernels against the torch
    and host placements (its sparse QIs take the anchored kernel), the risk
    profile of phase 3's Poker-hand mine (QIs of frequent items: the
    scanning kernel), then the planner on the card. Returns both coverage
    kernels' launches on the path, the table's host bitsets and its size-3
    quasi-identifiers (the kernel timing's sparse case)."""
    from repro_torch.core import DevicePlacement, HostPlacement, KyivConfig, prepare
    from repro_torch.core.kyiv import mine_preprocessed
    from repro_torch.data.synth import exposed_dataset
    from repro_torch.kernels import coverage as C
    from repro_torch.privacy import apply_plan, mine_masked, plan_anonymization, risk_profile
    from repro_torch.sdc.quasi import QuasiIdentifierReport, report_as_dict

    dev = str(device)
    t0 = time.perf_counter()
    D = exposed_dataset(n=PRIVACY_ROWS, m=6, seed=0)
    cfg = KyivConfig(tau=1, kmax=3, device=dev)
    prep = prepare(D, cfg)
    prep_s = time.perf_counter() - t0
    res, wall = {}, {}
    for engine in ("cuda", "torch", "numpy"):
        t0 = time.perf_counter()
        res[engine] = mine_preprocessed(prep, dataclasses.replace(cfg, engine=engine))
        torch.cuda.synchronize()
        wall[f"mine_{engine}_s"] = time.perf_counter() - t0
    for engine in ("torch", "numpy"):
        _same_mine(res[engine], res["cuda"], f"privacy: the {engine} mine against the cuda mine")

    # the main path: the report's risk profile through the coverage kernels
    # (on the mine's own placement), then the report; then the Poker-hand
    # mine's profile
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    report = QuasiIdentifierReport(result=res["cuda"], tau=1, kmax=3)
    t0 = time.perf_counter()
    profile = report.profile()
    torch.cuda.synchronize()
    wall["risk_profile_cuda_s"] = time.perf_counter() - t0
    got = report_as_dict(report)
    wall["report_cuda_s"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    exposed_launches = dict(C.LAUNCHES)
    t0 = time.perf_counter()
    poker_profile = risk_profile(poker_res)
    torch.cuda.synchronize()
    wall["poker_risk_profile_cuda_s"] = time.perf_counter() - t0
    launches = dict(C.LAUNCHES)
    missing = [k for k in (COVERAGE, ANCHORED) if launches[k] == 0]
    if missing:
        fail(f"privacy: the risk profiles never launched {missing} (launches {launches})")
    _same_profile(poker_profile, risk_profile(poker_res, placement=HostPlacement()),
                  "privacy: the Poker-hand profile against the host placement's")
    placements = {"torch": DevicePlacement("torch", device=dev), "numpy": HostPlacement()}
    for engine, placement in placements.items():
        t0 = time.perf_counter()
        prof = risk_profile(res[engine], placement=placement)
        torch.cuda.synchronize()
        wall[f"risk_profile_{engine}_s"] = time.perf_counter() - t0
        _same_profile(prof, profile, f"privacy: the {engine} placement's profile")
        want = report_as_dict(QuasiIdentifierReport(result=res[engine], tau=1, kmax=3, _profile=prof))
        if json.dumps(want) != json.dumps(got):
            fail(f"privacy: the {engine} report differs from the cuda report")
    by_size = report.by_size()
    qi3 = np.asarray([ids for ids, _ in res["cuda"].itemsets if len(ids) == 3], dtype=np.int32)
    table_bits = prep.table.bits
    del res, prep, profile
    torch.cuda.empty_cache()

    # the planner on the card, against the numpy engine's plan
    n_plan = 100_000
    P = exposed_dataset(n=n_plan, m=6, seed=0)
    t0 = time.perf_counter()
    plan = plan_anonymization(P, 1, 3, config=KyivConfig(device=dev))
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    post = mine_masked(apply_plan(P, plan), KyivConfig(tau=1, kmax=3, device=dev))
    if not plan.verified or (post is not None and post.itemsets):
        fail(f"privacy: the plan is not verified (residual {plan.residual_qis})")
    t0 = time.perf_counter()
    host_plan = plan_anonymization(P, 1, 3, config=KyivConfig(engine="numpy"))
    host_plan_s = time.perf_counter() - t0
    if host_plan.initial_qis != plan.initial_qis:
        fail(f"privacy: initial QIs {plan.initial_qis} on the card, {host_plan.initial_qis} on numpy")
    print("phase privacy: ok " + json.dumps({
        "dataset": f"exposed_dataset(n={PRIVACY_ROWS}, m=6, seed=0)", "tau": 1, "kmax": 3,
        "W": int(table_bits.shape[1]), "items": int(table_bits.shape[0]), "prepare_s": prep_s,
        "qis_by_size": {str(k): v for k, v in sorted(by_size.items())},
        "records_at_risk": got["unique_records"], "coverage_launches": launches,
        "exposed_launches": exposed_launches,
        "poker_qis": len(poker_res.itemsets),
        "report_peak_bytes": peak, **wall,
        "plan": {"dataset": f"exposed_dataset(n={n_plan}, m=6, seed=0)", "wall_s": plan_s,
                 "rounds": plan.rounds, "initial_qis": plan.initial_qis,
                 "suppressions": plan.cells_suppressed,
                 "generalized_columns": plan.generalized_columns, "verified": plan.verified,
                 "numpy_wall_s": host_plan_s,
                 "equal_to_numpy_plan": plan.as_dict(None) == host_plan.as_dict(None)},
    }), flush=True)
    return launches, table_bits, qi3


def _coverage_inputs(t, n_words, m, k, seed, weights, device, pad=True, sparse=False):
    """(t, n_words) random words, uploaded as the placement uploads them
    (``pad``: word axis padded to a multiple of 4) or as they are, with an
    empty row 0 and an all-ones row 1; with ``sparse``, a row 2 of sign-bit
    words and rows 3 to t/2 with about one word in 64 nonzero (short anchor
    lists); (m, k) sets with repeated items and sets on rows 0 and 1;
    weights in {0, 1, 2} or near 2**30 (sums overflow int32)."""
    from repro_torch.core.bitops import device_bits

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(t, n_words), dtype=np.uint32)
    if sparse and t >= 4:
        bits[3 : t // 2] *= rng.integers(0, 64, size=(t // 2 - 3, n_words)) == 0
        bits[2] = 0
        bits[2, ::3] = 0x80000000
    bits[0], bits[1] = 0, 0xFFFFFFFF
    sets = rng.integers(0, t, size=(m, k)).astype(np.int32)
    if m >= 3:
        sets[0], sets[1] = 1, 0
        sets[2, :] = sets[2, 0]
    if weights == "overflow":
        wt = (2**30 + rng.integers(-3, 4, size=m)).astype(np.int32)
        wt[::3] = -(2**30) - 5
    else:
        wt = rng.integers(0, 3, size=m).astype(np.int32)
    dbits = device_bits(bits, device) if pad else torch.from_numpy(bits.view(np.int32)).to(device)
    return (bits, sets, wt), (dbits, torch.from_numpy(sets).to(device), torch.from_numpy(wt).to(device))


def _coverage_bound(bits, sets, wt, rates, index=None) -> dict:
    """Least time for one batch, weight-0 sets needing no work. Both
    kernels write the (32, W) output once and read the sets and weights
    once, and the function adds each set bit of an AND to the output: 3
    operations a set bit. The scan (``index`` None) reads the distinct item
    rows once and does 2K operations per (live set, word) for the loads and
    ANDs. The anchored walk (``index.walk_anchors``, the walk of the
    anchored kernel) reads the index entries of its anchors, two offsets per
    distinct item and the distinct (item, word) member words it reads, once
    each, and does 2K operations per (live set, anchor word)."""
    from repro_torch.core.bitops import popcount32
    from repro_torch.kernels.coverage.index import anchors, walk_anchors

    m, k = sets.shape
    w = bits.shape[1]
    idx = sets[wt != 0].long()
    base = 32 * w * 4 + m * (k + 1) * 4
    if index is not None:
        anchor = anchors(index, idx)
        walk = walk_anchors(bits, index, idx, anchor, reads=True)
        counts = index.offsets[1:] - index.offsets[:-1]
        terms = {"pairs": int(walk.word.numel()),
                 "member_words": int(torch.unique(walk.reads).numel()),
                 "index_entries": int(counts[torch.unique(anchor)].sum().item()),
                 "items": int(torch.unique(idx).numel()),
                 "set_bits": int(popcount32(walk.x).to(torch.int64).sum().item())}
        nbytes = (base + terms["index_entries"] * 4 + terms["items"] * 16
                  + terms["member_words"] * 4)
        ops = 2 * k * terms["pairs"] + 3 * terms["set_bits"]
    else:
        set_bits = 0
        for chunk in idx.split(256):
            mask = bits[chunk[:, 0]]
            for j in range(1, k):
                mask &= bits[chunk[:, j]]
            set_bits += int(popcount32(mask).to(torch.int64).sum().item())
        terms = {"rows_read": int(torch.unique(idx).numel()), "set_bits": set_bits}
        nbytes = base + terms["rows_read"] * w * 4
        ops = idx.shape[0] * w * 2 * k + 3 * set_bits
    return {**_bound(nbytes, ops, 0, rates), "bytes": nbytes, "ops": ops, **terms}


def _time_coverage(label, bits, sets, wt, bound, index=None) -> dict:
    """One kernel on one batch, held against its plain version and the
    other plain version, timed beside its plain version and ``bound`` (the
    batch's :func:`_coverage_bound`): the anchored kernel where ``index`` is
    given (with the dispatch's anchor hint), the scanning kernel
    otherwise."""
    from repro_torch.kernels.coverage import (
        anchored_plan,
        coverage_accumulate_anchored,
        coverage_accumulate_anchored_ref,
        coverage_accumulate_indexed,
        coverage_accumulate_ref,
    )

    if index is not None:
        _, longest = anchored_plan(index.counts, sets.cpu().numpy(), wt.cpu().numpy(), bits.shape[1])
        kern = lambda: coverage_accumulate_anchored(bits, index, sets, wt, longest)
        plain = lambda: coverage_accumulate_anchored_ref(bits, index, sets, wt, chunk_pairs=1 << 22)
        name = ANCHORED
    else:
        kern = lambda: coverage_accumulate_indexed(bits, sets, wt)
        plain = lambda: coverage_accumulate_ref(bits, sets, wt)
        name = COVERAGE
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(got, coverage_accumulate_ref(bits, sets, wt)):
        fail(f"{name} {label}: differs from the plain versions")
    del got, want
    kernel_ms = time_ms(kern, 20)
    # a short kernel can finish before the host issues the next call: the
    # graph's replay times the device alone
    kernel_graph_ms = graph_ms(kern, 20)
    plain_ms = time_ms(plain, 3)
    return {"kernel": name, "kernel_ms": kernel_ms, "graph_ms": kernel_graph_ms, "plain_ms": plain_ms,
            "share": bound["bound_ms"] / kernel_ms, "graph_share": bound["bound_ms"] / kernel_graph_ms,
            "shape": {"t": int(bits.shape[0]), "W": int(bits.shape[1]), "M": int(sets.shape[0]),
                      "K": int(sets.shape[1]), "live_sets": int((wt != 0).sum().item())},
            **bound}


def _coverage_sweep(device) -> tuple[int, int]:
    """Both coverage kernels against the plain versions, bit for bit: the
    1M-, 500k- and 100k-row tables' widths as uploaded (31,252, 15,628 and
    3,128 words) and unpadded, small widths also against the host engine,
    K 1-4, weights that overflow int32, M up to the 500k table's bucket, on
    tables with empty, all-ones, sign-bit, sparse and random rows, the
    index built on each; the anchored kernel with the batch's longest anchor
    and with 1 (one slice per set)."""
    from repro_torch.kernels.coverage import (
        anchored_plan,
        build_coverage_index,
        coverage_accumulate_anchored,
        coverage_accumulate_anchored_ref,
        coverage_accumulate_host,
        coverage_accumulate_indexed,
        coverage_accumulate_ref,
    )

    checks = err = 0
    for n_words, pad in ((31_250, True), (15_625, True), (3_125, True), (31_250, False),
                         (3_125, False), (1, False), (3, False), (33, False)):
        for k in (1, 2, 3, 4):
            for weights in ("small", "overflow"):
                (hb, hs, hw), (bits, sets, wt) = _coverage_inputs(
                    64, n_words, 8192, k, seed=n_words + k, weights=weights, device=device, pad=pad,
                    sparse=True)
                index = build_coverage_index(bits)
                for m in (0, 1, 7, 4096, 8192):
                    s, x = sets[:m].contiguous(), wt[:m].contiguous()
                    longest = anchored_plan(index.counts, hs[:m], hw[:m], bits.shape[1])[1]
                    want = coverage_accumulate_ref(bits, s, x)
                    outs = {COVERAGE: [coverage_accumulate_indexed(bits, s, x)],
                            ANCHORED: [coverage_accumulate_anchored(bits, index, s, x, longest),
                                       coverage_accumulate_anchored(bits, index, s, x, 1),
                                       coverage_accumulate_anchored_ref(bits, index, s, x,
                                                                        chunk_pairs=1 << 22)]}
                    torch.cuda.synchronize()
                    if n_words <= 33:
                        host = torch.from_numpy(coverage_accumulate_host(hb, hs[:m], hw[:m]))
                        want_host = want[:, :n_words].cpu()
                        if not torch.equal(want_host, host):
                            fail(f"coverage W={n_words} K={k} M={m}: the plain version differs "
                                 "from the host engine")
                    for name, got in outs.items():
                        e = max(int((g.to(torch.int64) - want.to(torch.int64)).abs().max().item())
                                for g in got)
                        if e:
                            fail(f"{name} W={bits.shape[1]} K={k} M={m} weights={weights}: "
                                 f"max_abs_err={e}")
                        err, checks = max(err, e), checks + 1
                del bits, sets, wt, index
    torch.cuda.empty_cache()
    return checks, err


def phase_coverage_kernel(device, table_bits, qi3, rates):
    """Both coverage kernels against the plain versions over the sweep,
    then timed at the privacy path's batch: the table's padded width, K = 3
    and the bucket of a full batch (W = 15,628 and M = 8,192, the bucket of
    4,294 sets, for 500,000 rows). On the sparse batch of real QIs both
    kernels run (the dispatch picks the anchored one); on the dense batch of
    random rows the scanning one (the dispatch's pick). The index of the
    table is built and timed here."""
    from repro_torch.core.bitops import device_bits, padded_words
    from repro_torch.kernels.coverage import anchored_plan, build_coverage_index
    from repro_torch.kernels.intersect import next_bucket

    checks, err = _coverage_sweep(device)

    n_words = table_bits.shape[1]
    w_pad = padded_words(n_words)
    cap = max(256, (1 << 26) // n_words)  # CoverageEngine's batch cap at this W
    bucket = next_bucket(cap)
    if len(qi3) < cap:
        fail(f"coverage timing: only {len(qi3)} size-3 quasi-identifiers, need {cap}")
    chunk = np.pad(qi3[:cap], ((0, bucket - cap), (0, 0)), mode="edge")
    wchunk = np.pad(np.ones(cap, dtype=np.int32), (0, bucket - cap))
    bits = device_bits(table_bits, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_coverage_index(bits)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    anchored, longest = anchored_plan(index.counts, chunk, wchunk, w_pad)
    if not anchored:
        fail("coverage timing: the dispatch does not anchor the sparse batch")
    sets_d, wt_d = torch.from_numpy(chunk).to(device), torch.from_numpy(wchunk).to(device)
    # one bound for both kernels: the function's least work on this batch,
    # which is the walk's
    bound = _coverage_bound(bits, sets_d, wt_d, rates, index)
    sparse = _time_coverage("sparse", bits, sets_d, wt_d, bound, index)
    sparse_scan = _time_coverage("sparse", bits, sets_d, wt_d, bound)
    index_info = {"bytes": index.nbytes(), "nonzero_words": int(index.counts.sum()), "build_s": index_s,
                  "table_bytes": int(bits.numel()) * 4, "longest_anchor": longest}
    del bits, index, sets_d, wt_d
    torch.cuda.empty_cache()
    (_, dsets, _), (bits, sets, _) = _coverage_inputs(512, n_words, bucket, 3, seed=7, weights="small",
                                                      device=device)
    ones = torch.ones(sets.shape[0], dtype=torch.int32, device=device)
    dindex = build_coverage_index(bits)
    if anchored_plan(dindex.counts, dsets, ones.cpu().numpy(), bits.shape[1])[0]:
        fail("coverage timing: the dispatch anchors the dense batch")
    del dindex
    dense = _time_coverage("dense", bits, sets, ones, _coverage_bound(bits, sets, ones, rates))
    if bits.shape[1] != w_pad:
        fail(f"coverage timing: W={bits.shape[1]}, expected {w_pad}")
    del bits, sets
    torch.cuda.empty_cache()
    print("phase coverage-kernel: ok " + json.dumps({
        "checks": checks, "max_abs_err": err, "batch_cap": cap, "index": index_info,
        "sparse": {"inputs": f"the first {cap} size-3 QIs of the exposed table, "
                             f"padded to {bucket} with weight 0", ANCHORED: sparse, COVERAGE: sparse_scan,
                   "scan_over_anchored": sparse_scan["graph_ms"] / sparse["graph_ms"],
                   "scan_over_anchored_calls": sparse_scan["kernel_ms"] / sparse["kernel_ms"]},
        "dense": {"inputs": "512 random rows, random sets, weight 1", **dense},
    }), flush=True)
    return {"max_abs_err": err, "sparse": sparse, "sparse_scan": sparse_scan, "dense": dense}


# -- phase 9 -----------------------------------------------------------------


def _tiled_case(sizes, bm: int, w: int, seed: int, device):
    """Group-aligned rows of the prefix groups ``sizes`` (random words, an
    all-ones row, an empty row and duplicate rows; zero padding rows) and
    their block pairs, on ``device``."""
    from repro_torch.kernels.intersect import build_group_tiles

    row_map, ti, tj = build_group_tiles(np.asarray(sizes, dtype=np.int64), bm)
    rng = np.random.default_rng(seed)
    t = int(np.sum(sizes))
    bits = rng.integers(0, 2**32, size=(t, w), dtype=np.uint32)
    if t >= 4:
        bits[0], bits[1], bits[3] = 0xFFFFFFFF, 0, bits[2]
    pad = np.zeros((len(row_map), w), dtype=np.uint32)
    pad[row_map >= 0] = bits[row_map[row_map >= 0]]
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return as_dev(pad.view(np.int32)), as_dev(ti), as_dev(tj)


def _tiled_sweep(device) -> int:
    """The kernel against its plain version, bit for bit: block sizes 1, 2,
    3, 4, 8 and 16 at widths with 32-bit and 128-bit loads (with and
    without a partial 16-word chunk at the end), in three
    group layouts (edge: empty, one-row, one-block and ragged groups;
    single: one block pair, a CTA per sub-block over all words; many:
    hundreds of random groups), each on its first block pair and on all of
    them; then block indices out of range, which must give zero tiles."""
    from repro_torch.kernels.intersect import intersect_count_tiled, intersect_count_tiled_ref

    checks = 0
    for bm in (1, 2, 3, 4, 8, 16):
        for w in (1, 3, 4, 5, 20, 33, 3_128, 31_252):
            rng = np.random.default_rng(bm * 100_003 + w)
            n_groups = 600 if w <= 33 else 40 if w <= 3_128 else 6
            layouts = {"edge": [0, 1, 2, bm, bm + 1, 0, 3 * bm - 1], "single": [bm],
                       "many": rng.integers(0, 3 * bm + 2, size=n_groups)}
            for layout, sizes in layouts.items():
                bits, ti, tj = _tiled_case(sizes, bm, w, seed=checks, device=device)
                for n in sorted({1, ti.shape[0]}):
                    a, b = ti[:n].contiguous(), tj[:n].contiguous()
                    got = intersect_count_tiled(bits, a, b, block_rows=bm, block_words=w)
                    want = intersect_count_tiled_ref(bits, a, b, bm)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        fail(f"{TILED} bm={bm} W={w} {layout} T={n}: differs from its plain version "
                             f"(max_abs_err={_max_abs_err((got,), (want,))})")
                    checks += 1
    bits, _, _ = _tiled_case([16], 8, 40, seed=1, device=device)
    ti = torch.tensor([0, 2, -1, 1, 0, 1 << 30], dtype=torch.int32, device=device)
    tj = torch.tensor([1, 0, 0, 1, 7, 0], dtype=torch.int32, device=device)
    got = intersect_count_tiled(bits, ti, tj, block_rows=8, block_words=40)
    if not torch.equal(got, intersect_count_tiled_ref(bits, ti, tj, 8)) or got[[1, 2, 4, 5]].any():
        fail(f"{TILED}: block indices out of range do not give zero tiles")
    return checks + 1


def _level3_frontier(prep, device):
    """Level 3 of phase 3's mine (tau=1, kmax=4), as ``on_level_end`` hands
    it over before level 4 (host words, padding stripped), and that mine's
    level-4 candidates."""
    from repro_torch.core import KyivConfig
    from repro_torch.core.kyiv import mine_preprocessed

    states = {}
    res = mine_preprocessed(prep, KyivConfig(tau=1, kmax=4, device=str(device)),
                            on_level_end=lambda k, st: states.setdefault(st.next_k, st.level))
    return states[4], next(s.candidates for s in res.stats if s.k == 4)


def phase_tiled(device, prep, rates: dict) -> dict:
    """The tiled count's sweep, then its path at full width on the Poker-hand
    level-3 frontier: the counts of all within-group pairs against the
    pairwise count kernel and the plain version; timed beside both."""
    from repro_torch.core.bitops import padded_words
    from repro_torch.core.prefix import prefix_group_sizes
    from repro_torch.kernels.intersect import (
        build_group_tiles,
        counts_from_tiles,
        intersect_count_indexed,
        intersect_count_tiled,
        intersect_count_tiled_ref,
        locality_order,
    )
    from repro_torch.kernels.intersect import tiled as T

    checks = _tiled_sweep(device)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    level, candidates = _level3_frontier(prep, device)
    mine_s = time.perf_counter() - t0
    sizes = prefix_group_sizes(level.itemsets)
    row_map, ti, tj = build_group_tiles(sizes, TILED_BM)
    pos = np.flatnonzero(row_map >= 0)  # padded row of each frontier row
    if not np.array_equal(row_map[pos], np.arange(level.t)):
        fail(f"{TILED}: build_group_tiles does not keep the frontier's row order")
    # upload group-aligned at the device width: zero padding rows and words
    n_words = level.bits.shape[1]
    w = padded_words(n_words)
    t0 = time.perf_counter()
    bits = torch.zeros((len(row_map), w), dtype=torch.int32, device=device)
    for s in range(0, level.t, 4096):
        rows = torch.from_numpy(np.ascontiguousarray(level.bits[s : s + 4096]).view(np.int32))
        bits[torch.from_numpy(pos[s : s + 4096]).to(device), :n_words] = rows.to(device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t_level = level.t
    del level
    ti_d, tj_d = torch.from_numpy(ti).to(device), torch.from_numpy(tj).to(device)
    run = lambda: intersect_count_tiled(bits, ti_d, tj_d, block_rows=TILED_BM, block_words=w)

    # the path: counted from 0 just before it, read just after
    T.reset_launches()
    t0 = time.perf_counter()
    cnt = run()
    torch.cuda.synchronize()
    path_kernel_s = time.perf_counter() - t0
    launches = T.LAUNCHES[TILED]
    pairs, counts = counts_from_tiles(cnt.cpu().numpy(), ti, tj, row_map, TILED_BM)
    path_s = time.perf_counter() - t0
    if launches == 0:
        fail(f"{TILED}: the tiled path never launched the kernel")
    real_pairs = int((sizes * (sizes - 1) // 2).sum())
    if len(pairs) != real_pairs:
        fail(f"{TILED}: {len(pairs)} pairs from the tiles, {real_pairs} within-group pairs")

    # the same pairs through the pairwise kernel, in locality order and the
    # level pipeline's batches, on the same group-aligned rows
    order, _ = locality_order(pairs)
    if order is not None:
        pairs, counts = pairs[order], counts[order]
    pw = torch.from_numpy(pos[pairs].astype(np.int32)).to(device)
    batches = [pw[s : s + PAIRWISE_BATCH].contiguous() for s in range(0, len(pw), PAIRWISE_BATCH)]
    pairwise = torch.cat([intersect_count_indexed(bits, b) for b in batches])
    if not np.array_equal(pairwise.cpu().numpy().astype(np.int64), counts):
        fail(f"{TILED}: tiled counts differ from intersect_count_indexed's")
    want = intersect_count_tiled_ref(bits, ti_d, tj_d, TILED_BM)
    err = _max_abs_err((cnt,), (want,))
    if err:
        fail(f"{TILED} at the Poker-hand level: max_abs_err={err} against its plain version")
    del cnt, want, pairwise

    kernel_ms = time_ms(run, 10)
    plain_ms = time_ms(lambda: intersect_count_tiled_ref(bits, ti_d, tj_d, TILED_BM), 1, warmup=0)
    pairwise_ms = time_ms(lambda: [intersect_count_indexed(bits, b) for b in batches], 5)
    n_tiles, t_pad = len(ti), len(row_map)
    entries = n_tiles * TILED_BM * TILED_BM
    # the group-aligned rows and the block indices read once, the tiles
    # written once; per entry and word an AND and a carry-save sum, and a
    # popcount per HARLEY_SEAL_WORDS words (the ALU route), or 32 bit
    # products (the tensor route)
    bound = _bound(t_pad * w * 4 + n_tiles * 8 + entries * 4, OPS_PER_WORD * entries * w,
                   entries * w / HARLEY_SEAL_WORDS, rates, bit_products=entries * w * 32)
    # the limits of the two kernels' own designs, not the function's bound:
    # the tiled kernel's m8n8k128 products, the pairwise kernel's one
    # popcount per pair and word
    kernel_mma_ms = entries * w * 32 / rates["measured_per_s"]["mma_m8n8k128"] * 1e3
    pairwise_popc_ms = len(pairs) * w / rates["popc_per_s"] * 1e3
    n_batches = len(batches)
    del bits, ti_d, tj_d, pw, batches
    torch.cuda.empty_cache()
    out = {
        "checks": checks, "max_abs_err": err, "launches": launches,
        "frontier": {"dataset": "poker_like(n=1000000, m=10, seed=0)", "tau": 1, "kmax": 4,
                     "level": 3, "rows": t_level, "groups": len(sizes),
                     "largest_group": int(sizes.max()), "W": w, "mine_s": mine_s,
                     "upload_s": upload_s},
        "bm": TILED_BM, "T": n_tiles, "padded_rows": t_pad, "entries": entries,
        "real_pairs": real_pairs, "level4_candidates": candidates,
        "path_kernel_s": path_kernel_s, "path_s": path_s,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "pairwise_ms": pairwise_ms,
        "pairwise_launches": n_batches,
        "kernel_mma_ms": kernel_mma_ms, "pairwise_popc_ms": pairwise_popc_ms,
        "share": bound["bound_ms"] / kernel_ms,
        "pairwise_over_tiled": pairwise_ms / kernel_ms, **bound,
    }
    print("phase tiled: ok " + json.dumps(out), flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (the port must be in this checkout)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    rates = phase_device()
    n_words = (1_000_000 + 31) // 32  # the Poker-hand table's bitset width
    batch_cap = max(4096, (1 << 28) // n_words)  # core.frontier.mine_levels' batch cap
    from repro_torch.kernels.intersect import next_bucket

    timing = phase_kernels(device, n_words, next_bucket(batch_cap), rates)
    launches, *poker = phase_main(device)
    connect_launches, *connect = phase_host_classified(device)
    launches.update({k: v for k, v in connect_launches.items()
                     if k in ("intersect_write_indexed", "intersect_count_indexed")})
    launches.update(phase_gathered(device, poker, connect))
    poker_prep, poker_res = poker
    del poker, connect
    phase_checkpoint(device)
    cov_launches, table_bits, qi3 = phase_privacy(device, poker_res)
    launches.update(cov_launches)
    cov = phase_coverage_kernel(device, table_bits, qi3, rates)
    del table_bits, qi3, poker_res
    tiled = phase_tiled(device, poker_prep, rates)
    del poker_prep

    kernels = []
    for name, (replaces, _, _) in KERNELS.items():
        r = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            **({"gather_ms": r["gather_ms"]} if "gather_ms" in r else {}),
        })
    # the scanning kernel at the dense batch, which the dispatch gives it,
    # and beside it on the sparse batch, which the dispatch anchors. A
    # coverage kernel's ms is its time in a CUDA graph: the anchored one
    # ends before the host issues its next call, so back-to-back calls
    # (kernel_ms) time the wrapper's host work there
    d, sp = cov["dense"], cov["sparse_scan"]
    kernels.append({
        "name": COVERAGE, "route": "cuda", "source": COVERAGE_SOURCE, "replaces": COVERAGE_REPLACES,
        "launches": launches[COVERAGE], "max_abs_err": cov["max_abs_err"],
        "ms": d["graph_ms"], "kernel_ms": d["kernel_ms"], "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "library_ms": None,
        "sparse_ms": sp["graph_ms"], "sparse_plain_ms": sp["plain_ms"],
        "sparse_bound_ms": sp["bound_ms"], "sparse_bound_by": sp["bound_by"],
    })
    a = cov["sparse"]
    kernels.append({
        "name": ANCHORED, "route": "cuda", "source": COVERAGE_SOURCE, "replaces": COVERAGE_REPLACES,
        "launches": launches[ANCHORED], "max_abs_err": cov["max_abs_err"],
        "ms": a["graph_ms"], "kernel_ms": a["kernel_ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"], "library_ms": None,
        "scan_ms": sp["graph_ms"],
    })
    # launched by its own path only, as in the reference: no mine calls it.
    # No single PyTorch call counts bit intersections of packed words, so
    # library_ms is null; pairwise_ms is row 4's kernel over the same pairs
    kernels.append({
        "name": TILED, "route": "cuda", "source": TILED_SOURCE, "replaces": TILED_REPLACES,
        "launches": tiled["launches"], "max_abs_err": tiled["max_abs_err"],
        "ms": tiled["kernel_ms"], "kernel_ms": tiled["kernel_ms"], "plain_ms": tiled["plain_ms"],
        "bound_ms": tiled["bound_ms"], "bound_by": tiled["bound_by"], "library_ms": None,
        "pairwise_ms": tiled["pairwise_ms"],
    })
    print(f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
