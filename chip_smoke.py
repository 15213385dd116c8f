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
   kernel must write its child over its first operand; then the itemize
   kernels (``kernels/itemize``, phase itemize) against the host
   ``_itemize`` and their plain versions on the card, field for field, on
   the CPU tests' edge tables (both column routes), both benchmark cells'
   tables at full size and phase 7's exposed table, nothing left allocated,
   and timed at the cells' shapes beside their byte bound (the int64 table
   read once, the bits written once), the upload and the whole call; then
   the CRC-32 kernels (``kernels/crc32``, phase crc32) against ``zlib.crc32``
   of the same bytes on the host, at the CPU tests' edge lengths and at the
   job checkpoint's largest array (level 3 of the Poker-hand mine, 66,810 x
   32,032 words), contiguous and as the leading columns of a padded matrix
   read at its pitch, and timed beside their byte bound and zlib's time;
3. main path: a cold mine of the paper's Poker-hand shape (1,000,000 rows,
   10 columns, tau=1, kmax=4, default settings) with ``engine="cuda"``, then
   with ``engine="torch"`` on the same card; ``prepare`` must itemize on the
   card (each itemize kernel launched once) and give the host's item
   table; itemsets and per-level stats
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
   ``--ckpt-dir``, whose saves stream the level's bits from the card (each
   CRC kernel launched once per save with rows); the run is stopped after
   level 3 (level 4's checkpoint is removed), restored from disk and
   resumed, and must equal the uninterrupted mine;
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
8. service: the resident service, ``python -m repro_torch.launch.serve_miner``
   started with no ``--engine`` (the card), twice at once: both preload the
   Poker-hand table of phase 3 written to a CSV file (1,000,000 rows, not
   cut), one of them with ``--profile-dir``. Over HTTP the plain server
   answers a cold mine (tau=1, kmax=4), then after an append of 10,000 rows
   a mine past the incremental budget (a cold mine); the profiled one a
   profiled cold mine, the same mine from the cache, an append of 1,341 rows
   (the most that stay incremental, ``SERVICE_INCREMENTAL_ROWS``) and the
   incremental mine, ``/risk`` and ``/report``, an approximate mine served
   by the exact answer (kmax=4) and one sampled and refined in the
   background (kmax=2, epsilon=0.3); each answer equal to an in-process
   mine of the same rows (value sets), the cold mine's stats equal to
   phase 3's; ``/stats`` with no retried or refused request, warm intersect
   buckets and the server's own kernel launches (rows 1-4: the fused
   kernels of the cold mine, the unfused ones of the incremental mine's
   delta-born count, and a coverage kernel), ``/metrics`` lint-clean, the
   cold mine's ``torch.profiler`` trace (CUDA activity) naming the
   intersect kernels (its device busy and idle share and top kernels
   printed); then SIGTERM, and each server must exit 0;
9. durability: a third ``serve_miner`` on the card with ``--wal-dir``
   preloads phase 8's CSV; its cold mine (tau=1, kmax=4) saves a level
   checkpoint at each level boundary and is killed with SIGKILL once the
   level-2 step is committed. Restarted without ``--preload`` over the same
   directory, the server recovers the store from its write-ahead log and
   resumes the mine on the card from the newest committed step (the same
   step is also resumed in this process: phase 3's per-level stats);
   ``/debug/lastcrash`` names the killed mine and its last checkpointed
   level; the resumed answer, an incremental mine after an append of 1,341
   rows and ``/risk`` equal the in-process ones, and the server's launches
   show rows 1-2, 3 or 4, and the scanning coverage kernel. SIGTERM must exit
   0 and leave a snapshot; a third start recovers from it with no WAL
   record, reports the clean stop, serves ``/debug/bundle`` (gzipped JSON),
   and answers a durable cold mine, timed beside phase 8's plain one with
   each level checkpoint's bytes and seconds (from the flight ring), whose
   server launched each CRC kernel once per level save with rows;
10. mesh: the word-sharded mesh (``core.sharded``) on phase 3's Poker-hand
   mine, not cut: ``make_sharded_pipeline`` on a 2x2 mesh (pairs over
   ``data``, words over ``model``) with the device frontier, again with its
   cross-shard sums timed, with the host frontier, and on a 2x1 mesh; each
   must give phase 3's itemsets, per-level stats and level_bytes, launching
   the unfused kernels (rows 3-4) once per word shard and batch on the 2x2
   mesh and the fused ones (rows 1-2) on the 2x1 mesh. The entries are
   distinct cards where there are four, else cuda:0 four times (one tensor
   and one launch per entry all the same). Then the CLI's ``--sharded
   --mesh 2x2`` in a subprocess, phase 3's risk profile through the mesh's
   coverage dispatch (equal to phase 7's), and ``MiningService`` on a 2x2
   ``MeshPlacement``: cold, an append of 1,341 rows, incremental, each
   equal to phase 8's in-process mines; wall times, launches per shard,
   the sums' time and the peak memory printed;
11. fleet: two ``serve_miner`` processes on the card (``--num-processes 2``,
   ``--device cuda:0``, a ``TCPStore`` on a free port), each holding its
   round-robin word stripes; process 0 preloads phase 8's CSV (which
   crosses the command bus to process 1) and keeps its shadow. Over HTTP a
   cold mine, an append of 1,341 rows and the incremental mine, and
   ``/risk``, each equal to phase 8's in-process answers; ``/stats`` with no
   degradation and the collective's rounds, seconds and payload bytes (per
   level too). Then process 1 is killed with SIGKILL: the next append
   times out (``--fleet-timeout-s 10``) and the shadow, on the card,
   answers the next mine exactly; each process's peak memory printed;
12. coverage-kernel: both coverage kernels (scanning and anchored) against
   the plain versions on the card, bit for bit, over widths, set sizes,
   batch sizes, sparse and sign-bit rows and weights that overflow int32
   (640 checks), and against the numpy host engine on small inputs; the
   index of the 500k table built and timed; then timed at the privacy
   path's batch shape (W = 15,628, M = 8,192, K = 3) on real
   quasi-identifiers of phase 7 (sparse: both kernels) and on random rows
   (dense: the scanning kernel), by CUDA events over back-to-back calls
   and over the replay of a CUDA graph of 20 calls (the device alone);
   and the batches the Poker-hand mine's risk profile gives the dispatch
   (its quasi-identifiers by size, padded as ``CoverageEngine`` pads them:
   the scanning kernel), timed beside their bound;
13. tiled: the group-tiled count kernel against its plain version on the
   card, bit for bit, over block sizes, widths and group layouts (T from 1
   to a few thousand block pairs), then its path at full width: the level-3
   frontier of phase 3's table (66,810 rows in 3,066 prefix groups), from
   a second mine of phase 3's ``prep`` with an ``on_level_end`` hook, laid
   out group-aligned through ``build_group_tiles`` (bm = 8), counted by
   the kernel in one launch and mapped back by ``counts_from_tiles``; the
   counts of all within-group pairs must equal the pairwise count kernel's
   (``intersect_count_indexed``) and the plain version's, and the kernel is
   timed beside the pairwise kernel over the same pairs in the level
   pipeline's batches of 16,384;
14. lm: the LM scaffold's serving path (``repro_torch.models``, no kernel of
   rows 1-11: plain PyTorch). The ten reduced architectures on the card
   against the port on the CPU with the same weights (float32, prefill and
   8 decode steps, logits and every cache leaf within 1e-4); gemma3-4b at
   full width and depth in float32 (3.88B parameters), B = 2, S = 1,536
   (over its 1,024 window, so its local layers keep rings): 8 decode steps'
   logits equal to the full forward's within 2e-3; then ``python -m
   repro_torch.launch.serve --arch gemma3-4b --batch 8 --prompt-len 2048
   --max-new 64`` in a subprocess (the card, bfloat16), whose tokens must
   equal an in-process run of the same seed and be the full forward's
   greedy choices (wherever the top-2 margin exceeds 0.5), no two rows
   alike (each row repeats its prompt's last token: with random weights
   and a tied embedding the input token dominates the last hidden state);
   the prefill time, decode step (median and range), tokens/s and peak
   memory of both printed beside the decode step's memory bound;
15. train: training on one device (``repro_torch.training``, no kernel of
   rows 1-11). The ten reduced architectures each take one float32 step
   (``cast_bf16``, TF32 off) on the card from weights made on the CPU, and
   the loss, gradient norm, every parameter and both moments must equal the
   same step on the CPU (the CPU tests' rule: moments within 1e-4 of each
   leaf's largest but for at most 0.1% of entries within one bf16 ulp of
   the leaf's largest, parameters within 1e-6 of the update each side's own
   moments give); then ``python -m repro_torch.launch.train --arch
   granite-moe-1b-a400m --steps 8 --batch 8 --seq 2048 --lr 3e-4`` in a
   subprocess (full width and depth, 1.33B parameters, bf16 activations
   over float32 masters): every loss finite and the mean of the last two
   below the first; the step time (median and range after step 0),
   tokens/s and the peak memory printed beside the step's FLOP bound (6 x
   active parameters x tokens plus causal attention, at the data sheet's
   989 TFLOP/s); a ``torch.profiler`` trace of one warm step in this
   process (device busy and idle share, device time by operator); last,
   the CLI at reduced glm4-9b, 6 steps with checkpoints every 3, stopped
   after step 3 and resumed, must give the uninterrupted run's losses;
16. dist: the LM scaffold over a mesh (``distributed.sharding``, the plan
   step of ``training.train``, ``training.compression``,
   ``distributed.pipeline``, ``serving.decode_attn``; no kernel of rows
   1-11). The mesh entries repeat cuda:0 (one tensor and one step per
   entry; no number is a spread over cards). The ten reduced architectures
   each take one plan step on a 2x2 mesh of cuda:0 entries and on a 2x2
   mesh of CPU entries (phase train's rule), and on a 1x1 card mesh, which
   must equal the single-device step bit for bit; granite-moe-1b-a400m at
   full width (phase train's cell: B = 8, S = 2,048, lr 3e-4) takes one
   plan step on a 1x1 card mesh, which must equal the single-device step
   bit for bit, then 3 plan steps on 2x2 and the same 3 on 2x1 (dp = 2 on
   both: the same MoE routing groups), which must agree under the rule,
   with falling losses and every replicated slice bit-identical across its
   entries; the step time, tokens/s, the share of the FLOP bound and the
   peak memory printed, and a ``torch.profiler`` trace of one more 2x2
   step (device busy and idle share, the device time under the step's
   ``plan_step.gather`` and ``plan_step.reduce`` ranges); one
   int8-compressed step on 2x1 against the exact plan step
   (``cast_bf16=False``) on the same mesh and batch, within the reference
   test's bounds (loss 1e-4, parameters 5e-3, a parameter moved by more
   than 1e-6), and its reduced gradient, read back from its first moments
   and its gradient norm, within each leaf's shared int8 step of the exact
   step's; the same check must fail with the reference's biased reduce and
   with the sum that is not divided by the entries (controls); sequence-sharded
   decode attention at gemma3-4b's global-layer shapes (B = 1, 8 heads over
   4 KV heads of 256, a float32 cache of 131,072 positions) over 8 cuda:0
   entries, window 0 and 1,024, within 2e-5 of ``decode_attention`` on the
   whole cache, both timed; a 4-stage pipeline of RMS norm + GeGLU stages
   at gemma3-4b's widths (2,560 -> 10,240) over 8 micro-batches of 2,048
   tokens within 1e-5 (relative and absolute) of the sequential stack,
   both timed, beside ``bubble_fraction(4, 8)``; last, ``python -m
   repro_torch.launch.train --arch glm4-9b --reduced --mesh host --device
   cuda:0`` (4x2 of cuda:0), 4 steps with checkpoints at 2 and 4, resumed
   from step 2: the same losses and the same step-4 checkpoint, bit for
   bit;
17. roofline (no kernel of rows 1-11): ``launch.dryrun.lower_cell``'s
   arithmetic at the cells this smoke measured, reusing the earlier
   phases' results: phase dist's granite-moe-1b-a400m plan step on a 1x1
   mesh of the card and on its 2x2 (whose entries share the card: the
   step and bytes summed over them, ``_one_card``), and phase lm's
   gemma3-4b prefill and decode. Each measured step must take at least its
   roofline step time and each measured peak at least the bytes the step
   holds before it starts (``argument_bytes``); the two plan steps' peak
   estimates must lie within ``ROOFLINE_PEAK_BAND`` of their measured
   peaks, and the serving ones are printed beside theirs as a ratio. Last,
   the mining count row's ``t_memory`` at row 4's timed shape beside row
   4's time, and the tiled count priced on the H100 beside row 11's time
   and bound. The whole dry run runs on the CPU (``tests/
   test_torch_dryrun.py`` pins its records), not here.

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
this run's data: the scan's 2K per (live set, word) for the loads and ANDs
plus 3 per set bit of the ANDs, the anchored walk's 2K per (live set, anchor
word) plus 3 per set bit.

It prints a JSON line of per-kernel numbers and, last, the JSON status line.
Any mismatch, build failure or missing card exits non-zero before that line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.roofline.hw import H100  # noqa: E402  (the port must be in this checkout)

KERNEL_SOURCE = "src/repro_torch/kernels/intersect/csrc/intersect.cu"
COVERAGE = "coverage_accumulate_indexed"
ANCHORED = "coverage_accumulate_anchored"
COVERAGE_SOURCE = "src/repro_torch/kernels/coverage/csrc/coverage.cu"
COVERAGE_REPLACES = "src/repro/kernels/coverage/coverage.py:72"
PRIVACY_ROWS = 500_000
ITEMIZE = ("itemize_presence", "itemize_bits", "itemize_stats")
ITEMIZE_SOURCE = "src/repro_torch/kernels/itemize/csrc/itemize.cu"
ITEMIZE_REPLACES = "src/repro/core/items.py:115"  # the host itemize the kernels take over
CRC32 = ("crc32_blocks", "crc32_finish")
CRC32_SOURCE = "src/repro_torch/kernels/crc32/csrc/crc32.cu"
CRC32_REPLACES = "src/repro/distributed/checkpoint.py:69"  # zlib.crc32 of a tobytes() copy
# level 3 of the Poker-hand mine (tau=1, kmax=4): its stored rows and words,
# the job checkpoint's largest array (8.56 GB)
LEVEL3_ROWS, LEVEL3_WORDS = 66_810, 32_032
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
HBM_BYTES_PER_S = H100.hbm_bw  # H100 SXM device memory rate (data sheet): 3.35e12
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


def _path_shapes(n_words: int, batch_bucket: int) -> list[tuple]:
    """(label, kernels, W, M) of the batches that the multi-device paths
    give rows 1-4 on the Poker-hand table: a 2x1 mesh's pair block at the
    full width (rows 1-2), a 2x2 mesh's word shard and pair block, and the
    local stripes of process 0 of a two-process fleet at that width's batch
    cap (rows 3-4)."""
    from repro_torch.core.balance import balanced_blocks
    from repro_torch.core.bitops import padded_words
    from repro_torch.core.sharded import shard_width
    from repro_torch.kernels.intersect import next_bucket
    from repro_torch.service.store import DatasetStore

    store = DatasetStore(n_cols=1, shard=(0, 2))
    store.append(np.zeros((n_words * 32, 1), dtype=np.int64))
    fleet_w = padded_words(store.stats()["n_words"])
    block = balanced_blocks(batch_bucket, 2)[1]
    fused = ("intersect_classify_write_indexed", "intersect_classify_count_indexed")
    unfused = ("intersect_write_indexed", "intersect_count_indexed")
    return [("mesh 2x1", fused, padded_words(n_words), block),
            ("mesh 2x2", unfused, shard_width(n_words, 2), block),
            ("fleet", unfused, fleet_w, next_bucket(max(4096, (1 << 28) // fleet_w)))]


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

    path_checks = {}
    for label, names, w, m in _path_shapes(n_words, batch_bucket):
        n = 0
        for write in (True, False):
            bits, pairs, pc = _kernel_inputs(parents[write], w, m, seed=21, device=device)
            for name in names:
                if KERNELS[name][1] != write:
                    continue
                for tau in (0, 1, 5):
                    for mm in (0, 1, m):
                        kern, plain = _call(name, bits, pairs[:mm].contiguous(), pc, tau)
                        err = _max_abs_err(kern(), plain())
                        if err:
                            fail(f"{name} at the {label} shape W={w} M={mm} tau={tau}: "
                                 f"max_abs_err={err}")
                        n += 1
            del bits, pairs, pc
            torch.cuda.empty_cache()
        path_checks[label] = {"W": w, "M": m, "checks": n}
        checks += n
    print("  kernels at the mesh and fleet shapes: " + json.dumps(path_checks), flush=True)

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


# -- phase itemize ----------------------------------------------------------


def _load_file(name: str, path: Path):
    """A module of this checkout loaded by file (``bench/``, ``tests/`` are
    no packages)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell_table(generator: str) -> np.ndarray:
    """A benchmark cell's table at full size, from the benchmark's own
    generator (``bench/data/<generator>.py``), its rows in a drawn order."""
    mod = _load_file(f"bench_data_{generator}", ROOT / "bench" / "data" / f"{generator}.py")
    D = mod.make(n=1_025_010, m=10, seed=0) if generator == "poker_like" else mod.make()
    return np.ascontiguousarray(D[np.random.default_rng(2**31 + 5).permutation(len(D))])


def _same_table(got, want, label: str) -> None:
    """Every field of two item tables equal, dtypes and shapes included."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray) and (a.dtype != b.dtype or a.shape != b.shape):
            fail(f"{label}: {f.name} is {a.dtype}{a.shape}, the host's {b.dtype}{b.shape}")
        if not np.array_equal(a, b):
            fail(f"{label}: {f.name} differs from the host's")


def _itemize_timing(D: np.ndarray, device) -> dict:
    """The itemize kernels alone at ``D``'s shape (every column dense, as in
    both cells): the pass of ``kernels.itemize.ops.itemize_on_device`` up to
    its kernels, then the presence, bits and stats kernels timed by CUDA
    events beside their plain versions on the card and their byte bound
    (the int64 table read once, the bits written once); the upload and the
    whole call by the host's clock beside them."""
    from repro_torch.kernels.itemize import itemize_on_device, ops
    from repro_torch.kernels.itemize.ref import BASE, OFF, SPAN, SROW

    n, m = D.shape
    table, _ = ops._upload(D, device)
    lo, hi = torch.aminmax(table, dim=0)
    lo_hi = torch.stack((lo, hi)).cpu().numpy()
    plan, slots = ops._plan(lo_hi[0], lo_hi[1], n)
    if (plan[:, SROW] >= 0).any():
        fail(f"itemize timing: a sorted column at shape {D.shape}")
    params = torch.from_numpy(plan).to(device)
    present = torch.empty(slots, dtype=torch.uint8, device=device)
    ops._presence(table, plan, params, present, True)
    ex = torch.zeros(slots + 1, dtype=torch.int64, device=device)
    torch.cumsum(present, 0, dtype=torch.int64, out=ex[1:])
    counts = ex[params[:, OFF] + params[:, SPAN]] - ex[params[:, OFF]]
    host_counts = counts.cpu().numpy()
    n_items, n_words = int(host_counts.sum()), (n + 31) // 32
    plan[:, BASE] = np.cumsum(host_counts) - host_counts
    params[:, BASE] = torch.cumsum(counts, 0) - counts
    bits = torch.empty((n_items, n_words), dtype=torch.int32, device=device)
    freq = torch.empty(n_items, dtype=torch.int64, device=device)
    min_row = torch.empty_like(freq)
    no_sorted = torch.empty((0, n), dtype=torch.int64, device=device)

    def run(kernel: bool) -> None:
        ops._presence(table, plan, params, present, kernel)
        ops._bits_stats(table, plan, params, ex, no_sorted, bits, freq, min_row, kernel)

    kernel_ms = time_ms(lambda: run(True), 20)
    plain_ms = time_ms(lambda: run(False), 3)
    del table, present, ex, bits, freq, min_row, no_sorted
    torch.cuda.empty_cache()

    def wall_ms(fn, reps: int = 7) -> float:
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls[1:]))

    nbytes = n * m * 8 + n_items * n_words * 4
    return {"shape": [n, m], "items": n_items, "W": n_words, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "upload_ms": wall_ms(lambda: ops._upload(D, device)),
            "itemize_ms": wall_ms(lambda: itemize_on_device(D, device, "cuda"))}


def phase_itemize(device) -> dict:
    """The itemize kernels (``kernels/itemize/csrc/itemize.cu``) against the
    host ``_itemize`` and their plain versions on the card, field for field:
    the test tables' edge cases (both column routes), both cells' tables at
    full size and phase privacy's exposed table (a 25,000-item column);
    nothing left allocated; then timed at the cells' shapes."""
    from repro_torch.core.items import _itemize
    from repro_torch.data.synth import exposed_dataset
    from repro_torch.kernels.itemize import LAUNCHES, itemize_on_device, reset_launches

    t_phase = time.perf_counter()
    helpers = _load_file("itemize_helpers", ROOT / "tests" / "test_torch_itemize_helpers.py")
    reset_launches()
    checks, routes = 0, {"dense": 0, "sorted": 0}
    for case in sorted(helpers.CASES):
        for n in helpers.ROWS:
            D = helpers.CASES[case](n)
            want = _itemize(D)
            for engine in ("cuda", "torch"):
                got, attrs = itemize_on_device(D, device, engine)
                _same_table(got, want, f"itemize {case} n={n} engine={engine}")
                checks += 1
            routes["dense"] += attrs["dense_cols"]
            routes["sorted"] += attrs["sorted_cols"]
    full = {"poker-hand.cold-mine": _cell_table("poker_like"),
            "connect-4.cold-mine": _cell_table("connect4_uci"),
            "privacy": exposed_dataset(n=PRIVACY_ROWS, m=6, seed=0)}
    peaks = {}
    for label, D in full.items():
        want = _itemize(D)
        for engine in ("cuda", "torch"):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got, attrs = itemize_on_device(D, device, engine)
            torch.cuda.synchronize()
            if torch.cuda.memory_allocated() != held:
                fail(f"itemize {label} engine={engine}: "
                     f"{torch.cuda.memory_allocated() - held} bytes left allocated")
            peaks[f"{label}.{engine}"] = torch.cuda.max_memory_allocated() - held
            _same_table(got, want, f"itemize {label} engine={engine}")
            checks += 1
        del got, want
    launches = dict(LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"itemize: {missing} never launched ({launches})")
    rows = {label: _itemize_timing(full[label], device)
            for label in ("poker-hand.cold-mine", "connect-4.cold-mine")}
    torch.cuda.empty_cache()
    print("phase itemize: ok " + json.dumps({
        "checks": checks, "edge_routes": routes, "launches": launches,
        "temp_peak_bytes": peaks, "kernels": rows,
        "phase_s": time.perf_counter() - t_phase}), flush=True)
    return rows


def phase_crc32(device) -> dict:
    """The CRC-32 kernels (``kernels/crc32/csrc/crc32.cu``) against
    ``zlib.crc32`` of the same bytes on the host, their plain version: at
    the CPU tests' edge lengths (and one byte in), then at level 3's array,
    contiguous and as the leading ``LEVEL3_WORDS`` columns of a matrix
    padded by 8 words, read at its pitch; each call launches each kernel
    once. Then both timed by CUDA events beside their byte bound (the bytes
    read once) and zlib's time over the host copy."""
    import zlib

    from repro_torch.kernels.crc32 import LAUNCHES, crc32, crc32_launch, reset_launches, rows_view

    t_phase = time.perf_counter()
    reset_launches()
    calls = 0
    rng = np.random.default_rng(2**31 + 30)
    for length in (0, 1, 3, 4, 4095, (1 << 20) + 7):
        data = rng.integers(0, 256, length, dtype=np.uint8)
        t = torch.from_numpy(data).to(device)
        if crc32(t) != zlib.crc32(data):
            fail(f"crc32: {length} bytes differ from zlib")
        calls += length > 0
        if length > 1:
            if crc32(t[1:]) != zlib.crc32(data[1:]):
                fail(f"crc32: {length} bytes from the second differ from zlib")
            calls += 1
    rows, words = LEVEL3_ROWS, LEVEL3_WORDS
    padded = torch.randint(-(2**31), 2**31 - 1, (rows, words + 8), dtype=torch.int32,
                           device=device)
    view = padded[:, :words]
    level = view.contiguous()
    host = level.cpu().numpy()
    t0 = time.perf_counter()
    want = zlib.crc32(host)
    plain_ms = (time.perf_counter() - t0) * 1e3
    del host
    got = {"contiguous": crc32(level), "padded": crc32(view)}
    calls += 2
    if any(v != want for v in got.values()):
        fail(f"crc32: level 3's array {got}, zlib {want}")
    launches = dict(LAUNCHES)
    if launches != {k: calls for k in CRC32}:
        fail(f"crc32: launched {launches} in {calls} calls")
    nbytes = rows * words * 4
    row = {"shape": [rows, words], "pitch_words": words + 8, "bytes": nbytes,
           "kernel_ms": time_ms(lambda: crc32_launch(rows_view(level)), 10),
           "padded_ms": time_ms(lambda: crc32_launch(rows_view(view)), 10),
           "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    del padded, view, level
    torch.cuda.empty_cache()
    print("phase crc32: ok " + json.dumps({"checks": calls, "launches": launches, "kernels": row,
                                          "phase_s": time.perf_counter() - t_phase}), flush=True)
    return row


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
    from repro_torch.core.items import _itemize
    from repro_torch.data.synth import poker_like
    from repro_torch.kernels.itemize import LAUNCHES as ITEMIZE_LAUNCHES
    from repro_torch.kernels.itemize import reset_launches as reset_itemize_launches

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
    reset_itemize_launches()
    prep = prepare(D, cfg)
    prep_s = time.perf_counter() - t0
    item_launches = dict(ITEMIZE_LAUNCHES)
    if any(item_launches[k] != 1 for k in ITEMIZE):
        fail(f"main path: prepare did not itemize on the card once ({item_launches})")
    _same_table(prep.table, _itemize(D), "main path: the card's item table")
    summary, launches, res = _mine_pair(
        prep, cfg, "poker",
        ("intersect_classify_write_indexed", "intersect_classify_count_indexed"),
    )
    launches.update(item_launches)
    print("phase main: ok " + json.dumps({"dataset": "poker_like(n=1000000, m=10, seed=0)",
                                          "W": prep.l_bits.shape[1], "n_l": prep.n_l,
                                          "tau": 1, "kmax": 4, "prepare_s": prep_s,
                                          "itemize_launches": item_launches, **summary}),
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


def _bits_bytes(step_dir: Path) -> int:
    """The bytes of a committed checkpoint's ``bits`` array, by its
    manifest (0 where it has none)."""
    meta = json.loads((step_dir / "manifest.json").read_text())["arrays"].get("bits")
    return int(np.prod(meta["shape"])) * np.dtype(meta["dtype"]).itemsize if meta else 0


def phase_checkpoint(device):
    from repro_torch.core import KyivConfig, prepare
    from repro_torch.core.kyiv import mine_preprocessed
    from repro_torch.data.synth import poker_like
    from repro_torch.kernels import crc32 as crc
    from repro_torch.launch import mine as launch_mine

    n = 100_000
    work = ROOT / "build" / "smoke_checkpoint"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        crc.reset_launches()
        t0 = time.perf_counter()
        launch_mine.main(["--dataset", "poker", "--n", str(n), "--tau", "1", "--kmax", "4",
                          "--engine", "cuda", "--device", str(device),
                          "--ckpt-dir", str(work / "ckpt"), "--out", str(work / "out.json")])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        # the CLI's hook takes the level's words on the card: each save with
        # rows streams them, its CRC taken by the kernels
        crc_launches = dict(crc.LAUNCHES)
        saves = sum(_bits_bytes(p) > 0 for p in (work / "ckpt").glob("ckpt_*"))
        if not saves or crc_launches != {k: saves for k in CRC32}:
            fail(f"checkpoint: {saves} level saves with rows launched {crc_launches}")
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
        "crc32_launches": crc_launches,
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
    quasi-identifiers (the kernel timing's sparse case), and the Poker-hand
    mine's profile (phase mesh holds the mesh's against it)."""
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
    return launches, table_bits, qi3, poker_profile


# -- phase service -----------------------------------------------------------

# Rows of ``poker_like(n=10_000, m=10, seed=1)`` appended to the profiled
# server before its incremental mine: the largest prefix whose delta-born
# candidates (each appended row's 2- to kmax-item combinations, deduplicated)
# stay within IncrementalConfig's delta_candidate_budget of 262,144, the
# reference's; one row more passes it. The unprofiled server takes all
# 10,000 rows, which pass the budget, so its answer comes from a cold mine.
SERVICE_INCREMENTAL_ROWS = 1_341
SERVICE_COLD_APPEND_ROWS = 10_000


def _http(port: int, path: str, payload=None, timeout: float = 600.0):
    """One request to the server; returns (status, JSON body or text)."""
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    req = url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read().decode()
        kind = resp.headers.get("Content-Type", "")
        return resp.status, (json.loads(body) if kind.startswith("application/json") else body)


def _http_bytes(port: int, path: str, timeout: float = 600.0):
    """GET ``path``; returns (status, the body's raw bytes). A gzipped body
    (``Content-Encoding: gzip``) stays compressed."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        if resp.headers.get("Content-Encoding") != "gzip":
            fail(f"{path}: not gzipped ({resp.headers.get('Content-Encoding')})")
        return resp.status, resp.read()


def _value_sets_json(resp: dict) -> set:
    """A /mine answer as id-independent value sets."""
    return {(frozenset((int(c), int(v)) for c, v in s["items"]), int(s["count"]))
            for s in resp["itemsets"]}


def _value_sets(result) -> set:
    return {(frozenset((int(c), int(v)) for c, v in ids), int(cnt))
            for ids, cnt in result.as_value_sets()}


def _to_codes(rows: np.ndarray, books) -> np.ndarray:
    """Rows of raw values in the codebook space of ``read_csv`` (each
    column's sorted distinct strings)."""
    out = np.empty(rows.shape, dtype=np.int64)
    for j, book in enumerate(books):
        vals = rows[:, j].astype(str)
        out[:, j] = np.searchsorted(book, vals)
        if not np.array_equal(book[np.minimum(out[:, j], len(book) - 1)], vals):
            fail(f"service: an appended value of column {j} is not in the CSV's codebook")
    return out


def _trace_summary(path: str) -> dict:
    """Device busy and idle share of a profiled mine's device window (its
    first CUDA call to its last device activity; the profiler records CUDA
    activity only) and the five kernels with the most device time."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    on_device = ("kernel", "gpu_memcpy", "gpu_memset")
    window = [e for e in events if e.get("cat") in on_device + ("cuda_runtime", "cuda_driver")]
    t0 = min(e["ts"] for e in window)
    t1 = max(e["ts"] + e["dur"] for e in window)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in on_device)
    busy, end = 0.0, t0
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    per_kernel: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = per_kernel.setdefault(e["name"], [0.0, 0])
            k[0] += e["dur"]
            k[1] += 1
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:5]
    span = t1 - t0
    return {"window_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / span, "idle_share": 1 - busy / span,
            "kernels": sorted(per_kernel), "top_kernels": [
                {"name": n[:120], "ms": v[0] / 1e3, "calls": v[1]} for n, v in top]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_server(port: int, csv_path: Path | None, log_path: Path, extra: list[str]):
    """A ``serve_miner`` subprocess on the card; ``csv_path`` None starts it
    without ``--preload`` (a durable server recovering its store)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = open(log_path, "w")
    preload = ["--preload", str(csv_path)] if csv_path is not None else []
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_miner", "--port", str(port),
         *preload, *extra],
        cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc


def _wait_ready(label: str, proc, port: int, log_path: Path, t0: float) -> float:
    while True:
        if proc.poll() is not None:
            fail(f"service {label}: the server exited with {proc.returncode} during preload:\n"
                 + log_path.read_text()[-4000:])
        try:
            if _http(port, "/readyz", timeout=5)[1].get("ready"):
                return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > 300:
            fail(f"service {label}: the server was not ready within 300 s")
        time.sleep(0.25)


def _stop_server(label: str, proc, log_path: Path) -> None:
    """SIGTERM drains the server, which must exit 0."""
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        fail(f"service {label}: the server did not stop within 60 s of SIGTERM")
    if rc != 0:
        fail(f"service {label}: the server exited with {rc}:\n" + log_path.read_text()[-4000:])


def _no_refusal(label: str, stats: dict) -> None:
    res = stats["resilience"]
    if res["unavailable_mines"] or res["state"] != "closed" or res["device_retries"]:
        fail(f"service {label}: a request was retried or refused: {res}")
    if stats["placement"].get("engine") != "cuda" or stats["placement"].get("backend") != "cuda":
        fail(f"service {label}: the server did not place on the card: {stats['placement']}")


def phase_service(device, poker_res):
    """The resident service end to end: two ``python -m
    repro_torch.launch.serve_miner`` servers (no ``--engine``: the card)
    preload the Poker-hand 1M table from one CSV file at once. The plain
    one answers a cold mine, then after an append of 10,000 rows a mine
    that passes the incremental budget and comes from a cold mine. The one
    with ``--profile-dir`` answers a profiled cold mine, the same mine from
    its cache, an append of 1,341 rows and the incremental mine, ``/risk``
    and ``/report``, an approximate mine served by the exact answer and one
    sampled and refined in the background, then ``/stats``, ``/metrics`` and
    the cold mine's profile trace. Every answer is held against an
    in-process mine of the same rows. Returns what phase durability reuses:
    the CSV file (its directory is the caller's to remove), the table and
    the appended rows in its codebook, the in-process answers and risk
    profile, and the plain server's cold request time."""
    import tempfile
    import threading

    from repro_torch.core import KyivConfig, prepare
    from repro_torch.core.kyiv import mine_preprocessed
    from repro_torch.data.loaders import read_csv
    from repro_torch.data.synth import poker_like
    from repro_torch.obs.metrics import lint_exposition
    from repro_torch.privacy import risk_profile
    from repro_torch.sdc.quasi import QuasiIdentifierReport, report_as_dict

    dev = str(device)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_service_", dir=ROOT / "build"))
    csv_path, prof_dir = tmp / "poker.csv", tmp / "profile"
    logs = {"plain": tmp / "plain.log", "profiled": tmp / "profiled.log"}
    wall = {}
    t0 = time.perf_counter()
    np.savetxt(csv_path, poker_like(n=1_000_000, m=10, seed=0), fmt="%d", delimiter=",")
    wall["write_csv_s"] = time.perf_counter() - t0
    ports = {label: _free_port() for label in logs}
    t0 = time.perf_counter()
    procs = {"plain": _start_server(ports["plain"], csv_path, logs["plain"], []),
             "profiled": _start_server(ports["profiled"], csv_path, logs["profiled"],
                                       ["--profile-dir", str(prof_dir)])}
    try:
        # the in-process reference reads the same file while the servers preload
        loaded = {}
        reader = threading.Thread(target=lambda: loaded.setdefault("csv", read_csv(str(csv_path))))
        reader.start()
        for label, proc in procs.items():
            wall[f"preload_{label}_s"] = _wait_ready(label, proc, ports[label], logs[label], t0)
        print(f"  service: servers ready after {wall['preload_plain_s']:.2f} s (plain) and "
              f"{wall['preload_profiled_s']:.2f} s (profiled), preloading {csv_path.name} "
              "(1,000,000 rows) at once", flush=True)
        reader.join()
        table, _names, books = loaded["csv"]
        extra = _to_codes(poker_like(n=SERVICE_COLD_APPEND_ROWS, m=10, seed=1), books)

        requests = []

        def ask(label, server, path, payload=None):
            t = time.perf_counter()
            code, body = _http(ports[server], path, payload)
            dt = time.perf_counter() - t
            if code != 200:
                fail(f"service {label}: HTTP {code}: {body}")
            source = body.get("source") if isinstance(body, dict) else None
            requests.append({"request": label, "server": server, "path": path, "wall_s": dt,
                             "source": source, "server_latency_s":
                             body.get("latency_s") if isinstance(body, dict) else None})
            print(f"  service {label} ({server}): {dt:.4f} s source={source}", flush=True)
            return body

        cfg = KyivConfig(tau=1, kmax=4, engine="cuda", device=dev)

        def in_process(rows):
            prep = prepare(rows, cfg)
            t = time.perf_counter()
            res = mine_preprocessed(prep, cfg)
            torch.cuda.synchronize()
            return prep, res, time.perf_counter() - t

        # the plain server: a cold mine, then 10,000 appended rows, past the
        # incremental budget, answered by a cold mine
        cold = ask("cold", "plain", "/mine?tau=1&kmax=4")
        _, want, wall["inprocess_cold_s"] = in_process(table)
        if cold["source"] != "cold" or _value_sets_json(cold) != _value_sets(want):
            fail(f"service cold: source {cold['source']}, {cold['n_itemsets']} itemsets against "
                 f"{len(want.itemsets)} in-process")
        if list(map(stat_tuple, want.stats)) != list(map(stat_tuple, poker_res.stats)):
            fail("service: the mine of the CSV table differs in its stats from phase main's")
        app = ask(f"append {SERVICE_COLD_APPEND_ROWS}", "plain", "/append", {"rows": extra.tolist()})
        if app["n_rows"] != 1_000_000 + SERVICE_COLD_APPEND_ROWS:
            fail(f"service append: {app}")
        over = ask("mine past the budget", "plain", "/mine?tau=1&kmax=4")
        _, want_over, _ = in_process(np.concatenate([table, extra]))
        if over["source"] != "cold" or _value_sets_json(over) != _value_sets(want_over):
            fail(f"service mine past the budget: source {over['source']}, {over['n_itemsets']} "
                 f"itemsets against {len(want_over.itemsets)} of an in-process mine")
        _no_refusal("plain", ask("stats", "plain", "/stats"))
        _stop_server("plain", procs["plain"], logs["plain"])

        # the profiled server: cold (profiled), cached
        pcold = ask("cold, profiled", "profiled", "/mine?tau=1&kmax=4")
        if pcold["source"] != "cold" or _value_sets_json(pcold) != _value_sets(want):
            fail(f"service cold, profiled: source {pcold['source']}")
        if pcold["info"].get("profile_error"):
            fail(f"service: the profiler failed: {pcold['info']['profile_error']}")
        warm = ask("cache", "profiled", "/mine?tau=1&kmax=4")
        if warm["source"] != "cache" or _value_sets_json(warm) != _value_sets(want):
            fail(f"service cache: source {warm['source']}")

        # append, then the incremental mine against a cold one of all rows
        part = extra[:SERVICE_INCREMENTAL_ROWS]
        app = ask(f"append {SERVICE_INCREMENTAL_ROWS}", "profiled", "/append", {"rows": part.tolist()})
        if app["n_rows"] != 1_000_000 + SERVICE_INCREMENTAL_ROWS:
            fail(f"service append: {app}")
        inc = ask("incremental", "profiled", "/mine?tau=1&kmax=4")
        prep, cold_all, _ = in_process(np.concatenate([table, part]))
        if inc["source"] != "incremental" or _value_sets_json(inc) != _value_sets(cold_all):
            fail(f"service incremental: source {inc['source']}, {inc['n_itemsets']} itemsets "
                 f"against {len(cold_all.itemsets)} of a cold mine")

        # risk and report through the coverage kernels, against in-process
        drop = ("version", "source", "latency_s", "trace_id")
        risk = ask("risk", "profiled", "/risk?tau=1&kmax=4")
        profile = risk_profile(cold_all)
        want_risk = json.loads(json.dumps(profile.summary()))
        if {k: v for k, v in risk.items() if k not in drop} != want_risk:
            fail("service risk: differs from the in-process risk profile")
        rep = ask("report", "profiled", "/report?tau=1&kmax=4")
        want_rep = report_as_dict(QuasiIdentifierReport(result=cold_all, tau=1, kmax=4, _profile=profile))
        if {k: v for k, v in rep.items() if k not in drop} != json.loads(json.dumps(want_rep)):
            fail("service report: differs from the in-process report")

        # approximate: at kmax=4 the exact answer of this version serves;
        # at kmax=2 the sample is mined and refined in the background
        ap = ask("approx kmax=4", "profiled", "/mine?mode=approx&epsilon=0.1&tau=1&kmax=4")
        if not ap["info"].get("refined") or _value_sets_json(ap) != _value_sets(cold_all):
            fail(f"service approx kmax=4: {ap['info']}")
        sampled = ask("approx kmax=2", "profiled", "/mine?mode=approx&epsilon=0.3&tau=1&kmax=2")
        if sampled["source"] != "approx" or sampled["info"]["refined"]:
            fail(f"service approx kmax=2: expected a sampled answer, got {sampled['info']}")
        t = time.perf_counter()
        while True:
            refined = _http(ports["profiled"], "/mine?mode=approx&epsilon=0.3&tau=1&kmax=2")[1]
            if refined["info"].get("refined") is True:
                break
            if time.perf_counter() - t > 300:
                fail("service approx kmax=2: not refined within 300 s")
            time.sleep(0.1)
        wall["refine_wait_s"] = time.perf_counter() - t
        exact2 = mine_preprocessed(prep, dataclasses.replace(cfg, kmax=2))
        if _value_sets_json(refined) != _value_sets(exact2):
            fail("service approx kmax=2: the refined answer differs from the exact mine")
        print(f"  service approx kmax=2: sample_rows={sampled['info']['sample_rows']} "
              f"boundary={sampled['info']['boundary_count']} refined after {wall['refine_wait_s']:.3f} s "
              f"({refined['n_itemsets']} itemsets)", flush=True)
        del prep

        # stats, metrics, the trace
        stats = ask("stats", "profiled", "/stats")
        _no_refusal("profiled", stats)
        ex = stats["executables"]["families"]
        if ex.get("intersect", {}).get("hits", 0) <= 0:
            fail(f"service: no warm intersect buckets: {ex}")
        launches = stats["launches"]
        missing = [k for k in ("intersect_classify_write_indexed", "intersect_classify_count_indexed",
                               "intersect_write_indexed", "intersect_count_indexed")
                   if launches["intersect"][k] == 0]
        if missing or not sum(launches["coverage"].values()):
            fail(f"service: the server never launched {missing or 'a coverage kernel'}: {launches}")
        code, text = _http(ports["profiled"], "/metrics")
        problems = lint_exposition(text)
        if problems:
            fail(f"service /metrics: {problems[:5]}")
        batches = re.search(r"^repro_coverage_batches_total (\S+)", text, re.M)
        if not batches or float(batches.group(1)) <= 0:
            fail("service /metrics: repro_coverage_batches_total did not count the risk batches")
        trace_path = pcold["info"].get("profile_trace")
        if not trace_path or not Path(trace_path).is_file() or Path(trace_path).parent != prof_dir:
            fail(f"service: no profile trace of the cold mine ({trace_path})")
        trace = _trace_summary(trace_path)
        if not any("intersect_indexed_kernel" in k for k in trace["kernels"]):
            fail(f"service: the trace names no intersect kernel: {trace['kernels'][:10]}")
        print("  service trace (profiled cold mine, CUDA activity): " + json.dumps(
            {"profile_s": pcold["info"].get("profile_s"),
             **{k: v for k, v in trace.items() if k != "kernels"}}), flush=True)
        _stop_server("profiled", procs["profiled"], logs["profiled"])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print("phase service: ok " + json.dumps({
        "dataset": "poker_like(n=1000000, m=10, seed=0) via CSV",
        "appended_rows": {"incremental": SERVICE_INCREMENTAL_ROWS, "cold": SERVICE_COLD_APPEND_ROWS},
        "requests": requests, "qis": cold["n_itemsets"], "qis_after_append": inc["n_itemsets"],
        "cold_info": {k: cold["info"].get(k) for k in ("prepare_s",)},
        "profiled_cold_info": {k: pcold["info"].get(k) for k in ("prepare_s", "profile_s")},
        "incremental_info": {k: v for k, v in inc["info"].items() if k != "cost"},
        "past_budget_info": {k: over["info"].get(k) for k in ("prepare_s", "n_rows")},
        "sampled": {k: sampled["info"][k] for k in ("sample_rows", "tau_sample", "boundary_count",
                                                      "confidence")},
        "launches": {k: v for fam in launches.values() for k, v in fam.items() if v},
        "executables": stats["executables"], "trace": {k: v for k, v in trace.items() if k != "kernels"},
        **wall,
    }), flush=True)
    return {"tmp": tmp, "csv": csv_path, "table": table, "extra": extra, "want": want,
            "cold_all": cold_all, "risk": want_risk, "plain_cold_s": requests[0]["wall_s"]}


# -- phase durability --------------------------------------------------------

# the job directory holds two level checkpoints (keep=2): at the Poker-hand
# 1M table the level-3 step alone is ~8.4 GB (66,810 stored rows of 125,008
# B), beside the level-2 step, a killed run's unfinished step and the WAL
DURABILITY_FREE_BYTES = 12 * 10**9
DURABLE_JOB = "v1_t1_k4_ascending"  # version 1 of the store, tau=1, kmax=4


class _JobWatch:
    """Polls a service's ``wal_dir/jobs`` on a thread: for each level
    checkpoint written while it watches, when its temporary directory
    appeared, when the committed step appeared (``manifest.json`` inside),
    its bytes and its ``bits`` array's. Steps already committed when it
    starts are left out."""

    def __init__(self, jobs_root: Path):
        import threading

        self.root = jobs_root
        self.steps: dict[tuple[str, int], dict] = {}
        if jobs_root.is_dir():
            for job in jobs_root.iterdir():
                for step in _complete_steps(job):
                    self.steps[(job.name, step)] = {"old": True}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(0.005):
            try:
                jobs = list(self.root.iterdir())
            except FileNotFoundError:
                continue
            for job in jobs:
                try:
                    names = [p.name for p in job.iterdir()]
                except FileNotFoundError:
                    continue
                now = time.perf_counter()
                for name in names:
                    if not name.startswith("ckpt_") or name.endswith(".corrupt"):
                        continue
                    step = int(name[5:15])
                    rec = self.steps.setdefault((job.name, step), {"seen": now})
                    if name.endswith(".tmp") or "done" in rec or "old" in rec:
                        continue
                    path = job / name
                    if not (path / "manifest.json").is_file():
                        continue
                    try:
                        rec["bytes"] = sum(f.stat().st_size for f in path.iterdir())
                        rec["bits_bytes"] = _bits_bytes(path)
                    except FileNotFoundError:
                        rec["bytes"] = rec["bits_bytes"] = None
                    rec["done"] = now

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def landed(self, t0: float) -> list[dict]:
        """The committed steps: bytes, seconds from ``t0`` to the commit, and
        the write window (first sight of the step's directory to its commit)."""
        return [{"job": job, "level": step, "bytes": rec.get("bytes"),
                 "bits_bytes": rec.get("bits_bytes"), "landed_s": rec["done"] - t0, "write_s": rec["done"] - rec["seen"]}
                for (job, step), rec in sorted(self.steps.items()) if "done" in rec]


def _complete_steps(job_dir: Path) -> list[int]:
    if not job_dir.is_dir():
        return []
    return sorted(int(p.name[5:]) for p in job_dir.iterdir()
                  if p.name.startswith("ckpt_") and not p.name.endswith((".tmp", ".corrupt"))
                  and (p / "manifest.json").is_file())


def _ring_events(flight_dir: Path, incarnation: int) -> list[dict]:
    from repro_torch.obs.flight import read_segment

    events = []
    for side in ("a", "b"):
        events += read_segment(str(flight_dir / f"inc{incarnation}.{side}"))[0]
    return sorted(events, key=lambda e: e["seq"])


def _span_seconds(events: list[dict], name: str) -> dict[int, float]:
    """Durations of one incarnation's closed spans named ``name``, by their
    ``k`` attribute (the level)."""
    opened = {e["span_id"]: e for e in events if e["kind"] == "span.open" and e.get("name") == name}
    return {opened[e["span_id"]]["attrs"]["k"]: e["duration_s"] for e in events
            if e["kind"] == "span.close" and e.get("span_id") in opened}


def _async_get(port: int, path: str) -> dict:
    """GET ``path`` on a thread; the dict fills with the answer or the error
    and its wall time."""
    import threading

    out: dict = {}

    def run():
        t = time.perf_counter()
        try:
            out["code"], out["body"] = _http(port, path, timeout=1200)
        except Exception as exc:  # the server may be killed under it
            out["error"] = f"{type(exc).__name__}: {exc}"
        out["wall_s"] = time.perf_counter() - t

    out["thread"] = threading.Thread(target=run, daemon=True)
    out["thread"].start()
    return out


def phase_durability(device, poker_res, svc: dict):
    """The durable service at the Poker-hand 1M table: a ``serve_miner``
    with ``--wal-dir`` preloads phase service's CSV, takes a cold mine that
    saves a level checkpoint at each level boundary, and is killed with
    SIGKILL once its level-2 step is committed (and the flight ring holds
    its ``job.checkpoint`` event). Restarted without ``--preload`` over the
    same directory, it recovers the store from its WAL and resumes the mine
    on the card from the newest committed step; the answer equals phase
    service's in-process mine, and the same step resumed in this process
    gives phase main's per-level stats. ``/debug/lastcrash`` names the
    killed mine. Then an append answered incrementally, ``/risk``, and
    SIGTERM, which snapshots the store; a third start recovers from that
    snapshot alone, reports the clean stop, serves ``/debug/bundle``, and
    answers a durable cold mine, whose level checkpoints are timed from
    its flight ring."""
    from repro_torch.core import KyivConfig
    from repro_torch.core.kyiv import mine_preprocessed
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.service import MiningService
    from repro_torch.service.api import job_state

    import gzip

    t_phase = time.perf_counter()
    dev = str(device)
    wal = svc["tmp"] / "wal"
    wal.mkdir()
    free = shutil.disk_usage(wal).free
    if free < DURABILITY_FREE_BYTES:
        fail(f"durability: {free / 1e9:.1f} GB free under {wal}, the level checkpoints need "
             f"{DURABILITY_FREE_BYTES / 1e9:.0f} GB")
    jobs_root, job_dir, flight_dir = wal / "jobs", wal / "jobs" / DURABLE_JOB, wal / "flight"
    logs = [svc["tmp"] / f"durable{i}.log" for i in (1, 2, 3)]
    out: dict = {"free_gb": free / 1e9}
    procs = []

    def ask(port, path, label, payload=None):
        t = time.perf_counter()
        code, body = _http(port, path, payload)
        dt = time.perf_counter() - t
        if code != 200:
            fail(f"durability {label}: HTTP {code}: {body}")
        source = body.get("source") if isinstance(body, dict) else None
        print(f"  durability {label}: {dt:.4f} s source={source}", flush=True)
        out.setdefault("requests", []).append({"request": label, "wall_s": dt, "source": source})
        return body

    try:
        # 1. a durable server preloads the table: one WAL record
        port = _free_port()
        t0 = time.perf_counter()
        procs.append(_start_server(port, svc["csv"], logs[0], ["--wal-dir", str(wal)]))
        out["preload_s"] = _wait_ready("durable 1", procs[0], port, logs[0], t0)
        dur = ask(port, "/stats", "stats")["durability"]
        if dur["wal_appends"] != 1 or dur["last_recovery"]["version"] != 0:
            fail(f"durability: the preload did not land as one WAL record: {dur}")
        out["wal_bytes"] = dur["wal_bytes"]
        print(f"  durability: preload {out['preload_s']:.2f} s, WAL {dur['wal_bytes']:,} B, "
              f"durability {json.dumps({k: v for k, v in dur.items() if k != 'directory'})}",
              flush=True)

        # 2. a cold mine, killed with SIGKILL once its level-2 step is committed
        watch = _JobWatch(jobs_root)
        t_req = time.perf_counter()
        killed_req = _async_get(port, "/mine?tau=1&kmax=4")
        while True:
            if procs[0].poll() is not None:
                fail(f"durability: the server exited with {procs[0].returncode} before its "
                     "level-2 checkpoint:\n" + logs[0].read_text()[-4000:])
            if 2 in _complete_steps(job_dir) and any(
                    e["kind"] == "job.checkpoint" and e.get("level") == 2
                    for e in _ring_events(flight_dir, 1)):
                break
            if time.perf_counter() - t_req > 300:
                fail("durability: no level-2 checkpoint within 300 s")
            time.sleep(0.005)
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait()
        out["killed_after_s"] = time.perf_counter() - t_req
        watch.stop()
        killed_req["thread"].join(timeout=60)
        if "error" not in killed_req:
            fail(f"durability: the killed mine answered: {killed_req.get('code')}")
        left = _complete_steps(job_dir)
        newest = left[-1]
        out["killed_steps"] = watch.landed(t_req)
        out["steps_left"] = left
        print(f"  durability: SIGKILL {out['killed_after_s']:.3f} s after the request; "
              f"committed steps {left}; checkpoints that landed: {json.dumps(out['killed_steps'])}",
              flush=True)

        # the newest step, resumed in this process on the card from the
        # server's own table: phase main's per-level stats
        state_tree, _ = CheckpointManager(str(job_dir), keep=2).restore(newest)
        state = job_state(state_tree)
        del state_tree
        cfg = KyivConfig(tau=1, kmax=4, engine="cuda", device=dev)
        local = MiningService(engine="cuda", device=dev)
        local.append(svc["table"])
        version, table = local.store.snapshot()
        prep = local._prep_for(version, table, cfg)
        t = time.perf_counter()
        resumed_local = mine_preprocessed(prep, cfg, resume_state=state)
        torch.cuda.synchronize()
        out["inprocess_resume_s"] = time.perf_counter() - t
        local.close()
        del local, table, prep, state
        if list(map(stat_tuple, resumed_local.stats)) != list(map(stat_tuple, poker_res.stats)):
            fail("durability: the resumed mine's per-level stats differ from phase main's")
        if _value_sets(resumed_local) != _value_sets(svc["want"]):
            fail("durability: the resumed in-process mine differs from phase service's")
        del resumed_local
        torch.cuda.empty_cache()

        # 3. restart without --preload: recover the store, resume the job
        port = _free_port()
        watch = _JobWatch(jobs_root)
        t0 = time.perf_counter()
        procs.append(_start_server(port, None, logs[1], ["--wal-dir", str(wal)]))
        out["recover_s"] = _wait_ready("durable 2", procs[1], port, logs[1], t0)
        resumed_req = _async_get(port, "/mine?tau=1&kmax=4")
        stats = ask(port, "/stats", "stats after restart")
        dur = stats["durability"]
        rec = dur["last_recovery"]
        if (dur["resumed_jobs"] != 1 or rec["replayed"] != 1 or rec["snapshot_version"] != 0
                or stats["store"]["version"] != 1 or stats["store"]["n_rows"] != 1_000_000):
            fail(f"durability: recovery {rec}, resumed {dur['resumed_jobs']}, store {stats['store']}")
        report = ask(port, "/debug/lastcrash", "lastcrash")["report"]
        open_names = [sp["name"] for sp in report["open_spans"]]
        if (report["clean_shutdown"] or not any(n.startswith("mine.") for n in open_names)
                or (report["last_checkpoint"] or {}).get("level") != newest):
            fail(f"durability: /debug/lastcrash {json.dumps(report)[:2000]}")
        if "previous incarnation died uncleanly" not in logs[1].read_text():
            fail("durability: the restarted server did not warn of the unclean stop")
        out["lastcrash"] = {"clean_shutdown": report["clean_shutdown"], "open_spans": open_names,
                            "last_checkpoint_level": report["last_checkpoint"]["level"],
                            "last_completed_level": report["last_completed_level"],
                            "active_request_keys": report["active_request_keys"]}
        print(f"  durability: ready after {out['recover_s']:.2f} s without --preload; recovery "
              f"{json.dumps(rec)}; lastcrash {json.dumps(out['lastcrash'])}", flush=True)

        # 4. the resumed mine
        resumed_req["thread"].join(timeout=1200)
        if "error" in resumed_req or resumed_req["code"] != 200:
            fail(f"durability: resumed mine {resumed_req.get('error') or resumed_req.get('code')}")
        res = resumed_req["body"]
        out["resumed_mine_s"] = resumed_req["wall_s"]
        if res["source"] != "cold" or res["info"].get("resumed_from_level") != newest + 1:
            fail(f"durability: resumed mine source {res['source']}, info {res['info']}")
        if _value_sets_json(res) != _value_sets(svc["want"]):
            fail("durability: the resumed mine differs from the in-process mine")
        launches = ask(port, "/stats", "stats after the resumed mine")["launches"]["intersect"]
        need = ["intersect_classify_count_indexed"] + (
            ["intersect_classify_write_indexed"] if newest + 1 < 4 else [])
        if any(launches[k] == 0 for k in need):
            fail(f"durability: the resumed mine did not launch {need}: {launches}")
        watch.stop()
        out["resumed_steps"] = watch.landed(t0)
        out["resumed_launches"] = {k: v for k, v in launches.items() if v}
        print(f"  durability: resumed from level {newest + 1} in {out['resumed_mine_s']:.3f} s "
              f"(from the restart's ready); launches {out['resumed_launches']}; checkpoints "
              f"{json.dumps(out['resumed_steps'])}", flush=True)

        # 5. incremental after recovery, then risk
        part = svc["extra"][:SERVICE_INCREMENTAL_ROWS]
        app = ask(port, "/append", f"append {SERVICE_INCREMENTAL_ROWS}", {"rows": part.tolist()})
        if app["version"] != 2 or app["n_rows"] != 1_000_000 + SERVICE_INCREMENTAL_ROWS:
            fail(f"durability append: {app}")
        inc = ask(port, "/mine?tau=1&kmax=4", "incremental")
        if inc["source"] != "incremental" or _value_sets_json(inc) != _value_sets(svc["cold_all"]):
            fail(f"durability incremental: source {inc['source']}")
        risk = ask(port, "/risk?tau=1&kmax=4", "risk")
        drop = ("version", "source", "latency_s", "trace_id")
        if {k: v for k, v in risk.items() if k not in drop} != svc["risk"]:
            fail("durability risk: differs from the in-process risk profile")
        stats = ask(port, "/stats", "stats after risk")
        after = stats["launches"]
        if not (after["intersect"]["intersect_write_indexed"] > launches["intersect_write_indexed"]
                or after["intersect"]["intersect_count_indexed"] > launches["intersect_count_indexed"]):
            fail(f"durability: the incremental mine launched neither row 3 nor row 4: {after}")
        if not after["coverage"].get(COVERAGE):
            fail(f"durability: /risk did not launch {COVERAGE}: {after['coverage']}")
        _no_refusal("durable 2", stats)
        out["wal_bytes_after_append"] = stats["durability"]["wal_bytes"]

        # 6. SIGTERM: exit 0, a fresh snapshot, the completed job gone
        _stop_server("durable 2", procs[1], logs[1])
        snap = CheckpointManager(str(wal / "snapshots"), keep=2).latest_step()
        if snap != 2 or (jobs_root.is_dir() and any(jobs_root.iterdir())):
            fail(f"durability: after SIGTERM the snapshot is v{snap}, jobs "
                 f"{sorted(p.name for p in jobs_root.iterdir()) if jobs_root.is_dir() else []}")
        port = _free_port()
        watch = _JobWatch(jobs_root)
        t0 = time.perf_counter()
        procs.append(_start_server(port, None, logs[2], ["--wal-dir", str(wal)]))
        out["clean_recover_s"] = _wait_ready("durable 3", procs[2], port, logs[2], t0)
        rec = ask(port, "/stats", "stats after a clean stop")["durability"]["last_recovery"]
        if rec["snapshot_version"] != 2 or rec["replayed"] != 0 or rec["version"] != 2:
            fail(f"durability: the clean restart recovered {rec}")
        report = ask(port, "/debug/lastcrash", "lastcrash after a clean stop")["report"]
        if not report["clean_shutdown"]:
            fail(f"durability: the clean stop reads as a crash: {json.dumps(report)[:2000]}")
        code, raw = _http_bytes(port, "/debug/bundle")
        bundle = json.loads(gzip.decompress(raw))
        if code != 200 or "lastcrash" not in bundle or not bundle["lastcrash"]["clean_shutdown"]:
            fail(f"durability: /debug/bundle {code} {sorted(bundle)}")
        out["bundle_bytes"] = len(raw)

        # 7. a durable cold mine, against the plain server's
        crc_before = ask(port, "/stats", "stats before the durable cold mine")["launches"]["crc32"]
        cold = ask(port, "/mine?tau=1&kmax=4", "durable cold")
        if cold["source"] != "cold" or _value_sets_json(cold) != _value_sets(svc["cold_all"]):
            fail(f"durability: the durable cold mine: source {cold['source']}")
        out["durable_cold_s"] = out["requests"][-1]["wall_s"]
        watch.stop()
        out["durable_steps"] = watch.landed(t0)
        # each level save with rows streamed its bits, CRC'd on the card
        crc_after = ask(port, "/stats", "stats after the durable cold mine")["launches"]["crc32"]
        saves = sum((st["bits_bytes"] or 0) > 0 for st in out["durable_steps"])
        out["crc32_launches"] = {k: crc_after[k] - crc_before[k] for k in CRC32}
        if not saves or out["crc32_launches"] != {k: saves for k in CRC32}:
            fail(f"durability: {saves} level saves with rows launched {out['crc32_launches']}")
        _stop_server("durable 3", procs[2], logs[2])
        events = _ring_events(flight_dir, 3)
        out["checkpoint_s"] = _span_seconds(events, "mine.checkpoint")
        out["level_s"] = _span_seconds(events, "mine.level")
        if sorted(out["checkpoint_s"]) != [2, 3, 4] or any(jobs_root.iterdir()):
            fail(f"durability: the durable cold mine's checkpoints {out['checkpoint_s']}")
        out["plain_cold_s"] = svc["plain_cold_s"]
        print(f"  durability: durable cold mine {out['durable_cold_s']:.3f} s against the plain "
              f"server's {out['plain_cold_s']:.3f} s (phase service); level checkpoints "
              f"(s, from the flight ring) {json.dumps(out['checkpoint_s'])}, steps "
              f"{json.dumps(out['durable_steps'])}", flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["phase_s"] = time.perf_counter() - t_phase
    print("phase durability: ok " + json.dumps(
        {"dataset": "poker_like(n=1000000, m=10, seed=0) via CSV", "tau": 1, "kmax": 4, **out},
        default=str), flush=True)
    return out["crc32_launches"]


# -- phase mesh --------------------------------------------------------------

# a 2x2 mesh on one card holds each level's parents twice (level 3's: 2 x
# 8.35 GB), the stored children once more while the next level's parents
# are assembled, and two batches of pair-sharded children
MESH_FREE_BYTES = 40 * 10**9


def _mesh_devices(n: int) -> tuple[list, str]:
    """n distinct cards where there are n, else cuda:0 n times."""
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], f"{n} distinct cards"
    return [torch.device("cuda", 0)] * n, f"cuda:0 repeated {n} times"


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _peaks() -> dict:
    return {f"cuda:{i}": torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())}


def _reset_peaks() -> None:
    torch.cuda.empty_cache()
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def _shard_counts(placement, site: str) -> dict:
    return {f"{d},{w}": n for (s, d, w), n in sorted(placement.shard_launches.items()) if s == site}


class _CheckedShards:
    """Instruments one mesh mine: every shard call of rows 3-4
    (``core.sharded._local_intersect``) is held against the plain version on
    the same inputs, bit for bit, and every cross-shard sum
    (``core.sharded._sum_to``) is timed on the host clock, each ending in a
    device sync. The check adds no kernel launch. Install it before the
    pipeline factory is built (the level steps bind their shard body then)."""

    def __init__(self):
        import repro_torch.core.sharded as sh

        self.sh = sh
        self.real = (sh._local_intersect, sh._sum_to)
        self.calls, self.shapes = 0, set()
        self.sum_s, self.sums = 0.0, 0

    def _local(self, bits, pairs, pc, tau, *, write_children, **kw):
        from repro_torch.kernels.intersect import ref as R

        child, cnt = self.real[0](bits, pairs, pc, tau, write_children=write_children, **kw)
        err = 0
        for lo in range(0, int(pairs.shape[0]), 2048):  # bounds the plain version's temporaries
            sub = pairs[lo : lo + 2048]
            if write_children:
                err = max(err, _max_abs_err((child[lo : lo + 2048], cnt[lo : lo + 2048]),
                                            R.intersect_pairs_ref(bits, sub)))
            else:
                err = max(err, _max_abs_err((cnt[lo : lo + 2048],),
                                            (R.intersect_count_ref(bits, sub),)))
        if err:
            fail(f"mesh: a shard's {'write' if write_children else 'count'} call "
                 f"(W={bits.shape[1]}, M={pairs.shape[0]}) differs from the plain version: "
                 f"max_abs_err={err}")
        self.calls += 1
        self.shapes.add((bool(write_children), int(bits.shape[1]), int(pairs.shape[0])))
        return child, cnt

    def _sum(self, parts, dev):
        devs = {p.device for p in parts} | {torch.device(dev)}
        for d in devs:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        out = self.real[1](parts, dev)
        for d in devs:
            torch.cuda.synchronize(d)
        self.sum_s += time.perf_counter() - t0
        self.sums += 1
        return out

    def __enter__(self):
        self.sh._local_intersect, self.sh._sum_to = self._local, self._sum
        return self

    def __exit__(self, *exc):
        self.sh._local_intersect, self.sh._sum_to = self.real


def phase_mesh(device, prep, poker_res, main_wall_s: float, poker_profile, svc: dict) -> dict:
    """The word-sharded mesh on the Poker-hand 1M mine of phase main (tau=1,
    kmax=4, not cut): ``make_sharded_pipeline`` on a 2x2 mesh with the
    device frontier, with the host frontier, and on a 2x1 mesh (one word
    shard: the fused kernels); every mine must give phase main's itemsets,
    per-level stats and level_bytes. One more 2x2 mine holds every shard
    call of rows 3-4 against the plain version and times the cross-shard
    sums (``_CheckedShards``); its wall time is not the mesh's.
    Then ``python -m repro_torch.launch.mine --sharded --mesh 2x2`` in a
    subprocess, phase main's risk profile through the mesh's coverage
    dispatch (equal to phase privacy's), and ``MiningService`` on a 2x2
    ``MeshPlacement``: a cold mine, an append of 1,341 rows, the incremental
    mine, each equal to phase service's in-process mines. The mesh's
    entries are distinct cards where there are four, else cuda:0 four times.
    Returns the launches of rows 1-4 and 10 in this phase."""
    from repro_torch.core import KyivConfig
    from repro_torch.core.kyiv import mine_preprocessed
    from repro_torch.core.placement import MeshPlacement
    from repro_torch.core.sharded import make_sharded_pipeline
    from repro_torch.kernels import coverage as C
    from repro_torch.kernels import intersect as I
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.privacy import risk_profile
    from repro_torch.service import MiningService

    t_phase = time.perf_counter()
    _reset_peaks()
    free = torch.cuda.mem_get_info(device)[0]
    if free < MESH_FREE_BYTES:
        fail(f"mesh: {free / 1e9:.1f} GB free on the card, the 2x2 mesh needs {MESH_FREE_BYTES / 1e9:.0f}")
    dev = str(device)
    cfg = KyivConfig(tau=1, kmax=4, engine="cuda", device=dev)
    devs4, kind4 = _mesh_devices(4)
    devs2, kind2 = _mesh_devices(2)
    print(f"  mesh: 2x2 entries are {kind4}; 2x1 entries are {kind2}", flush=True)
    mesh22 = mesh_from_spec("2x2", devices=devs4)
    mesh21 = mesh_from_spec("2x1", devices=devs2)
    phase_launches = {k: 0 for k in I.LAUNCHES}
    out = {"entries_2x2": kind4, "entries_2x1": kind2, "main_wall_s": main_wall_s, "mines": []}
    runs = [("2x2 device frontier", mesh22, True, False),
            ("2x2 host frontier", mesh22, False, False),
            ("2x1 device frontier", mesh21, True, False),
            ("2x2 device frontier, checked", mesh22, True, True)]
    for label, mesh, front, checked in runs:
        check = _CheckedShards() if checked else contextlib.nullcontext()
        with check:
            factory = make_sharded_pipeline(mesh, word_axis="model", engine="cuda",
                                            device_frontier=front)
        placement = factory.placement
        _reset_peaks()
        I.reset_launches()
        t0 = time.perf_counter()
        with check:
            res = mine_preprocessed(prep, cfg, pipeline_factory=factory)
            _sync_all()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in I.LAUNCHES.items() if v}
        for k, v in launches.items():
            phase_launches[k] += v
        _same_mine(res, poker_res, f"mesh {label}")
        per_shard = _shard_counts(placement, "dispatch")
        rows = (("intersect_classify_write_indexed", "intersect_classify_count_indexed")
                if placement.word_shards == 1 else ("intersect_write_indexed", "intersect_count_indexed"))
        others = [k for k in launches if k not in rows]
        if others or any(launches.get(k, 0) == 0 for k in rows):
            fail(f"mesh {label}: launched {launches}, expected only {rows}")
        if sum(launches.values()) != sum(per_shard.values()) or len(set(per_shard.values())) != 1:
            fail(f"mesh {label}: {launches} launches against per-shard dispatches {per_shard}")
        rec = {"mesh": label, "wall_s": wall, "mine_wall_s": res.wall_time, "launches": launches,
               "launches_per_shard": per_shard, "peak_bytes": _peaks(),
               "level_s": [s.time_total for s in res.stats]}
        if checked:
            if check.calls != sum(per_shard.values()) or check.sums != check.calls // 2:
                fail(f"mesh {label}: {check.calls} shard calls checked and {check.sums} sums "
                     f"against per-shard dispatches {per_shard}")
            rec.update({"calls_held_against_plain": check.calls,
                        "shapes_held": sorted(check.shapes), "sum_s": check.sum_s,
                        "sum_calls": check.sums})
        out["mines"].append(rec)
        print(f"  mesh {label}: {wall:.3f} s against phase main's {main_wall_s:.3f} s; "
              + json.dumps({k: v for k, v in rec.items() if k not in ("mesh", "wall_s")}), flush=True)
        del res, factory, placement
    _reset_peaks()

    # the CLI, in a subprocess
    tmp = ROOT / "build" / "smoke_mesh"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cli_dev = "cuda" if torch.cuda.device_count() >= 4 else "cuda:0"
    cmd = [sys.executable, "-m", "repro_torch.launch.mine", "--sharded", "--mesh", "2x2",
           "--device", cli_dev, "--dataset", "poker", "--n", "1000000", "--tau", "1",
           "--kmax", "4", "--out", str(tmp / "cli.json")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0 or "sharded over mesh {'data': 2, 'model': 2}" not in proc.stdout:
        fail(f"mesh CLI: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    got = json.loads((tmp / "cli.json").read_text())
    if sorted((tuple(s["items"]), s["count"]) for s in got["itemsets"]) != sorted(poker_res.itemsets):
        fail("mesh CLI: itemsets differ from phase main's")
    if [tuple(s[k] for k in ("k", "candidates", "support_pruned", "bound_pruned", "intersections",
                             "emitted", "skipped_absent_uniform", "stored")) for s in got["stats"]] \
            != list(map(stat_tuple, poker_res.stats)):
        fail("mesh CLI: per-level stats differ from phase main's")
    out["cli_s"] = cli_s
    print(f"  mesh CLI --sharded --mesh 2x2 --device {cli_dev}: {cli_s:.2f} s (the subprocess, "
          f"table generation included): {proc.stdout.splitlines()[0]}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)

    # the risk profile through the mesh's coverage dispatch
    cov_placement = MeshPlacement(mesh22, word_axis="model", engine="cuda")
    C.reset_launches()
    t0 = time.perf_counter()
    prof = risk_profile(poker_res, placement=cov_placement)
    _sync_all()
    out["risk_profile_s"] = time.perf_counter() - t0
    _same_profile(prof, poker_profile, "mesh risk profile against phase privacy's")
    cov = {k: v for k, v in C.LAUNCHES.items() if v}
    cov_shards = _shard_counts(cov_placement, "coverage")
    if not cov or sum(cov.values()) != sum(cov_shards.values()):
        fail(f"mesh risk: coverage launches {cov} against per-shard dispatches {cov_shards}")
    for k, v in cov.items():
        phase_launches[k] = phase_launches.get(k, 0) + v
    out["risk"] = {"launches": cov, "launches_per_shard": cov_shards}
    print(f"  mesh risk profile: {out['risk_profile_s']:.3f} s; " + json.dumps(out["risk"]), flush=True)
    del prof, cov_placement

    # the resident service on the mesh
    _reset_peaks()
    svc_mesh = MiningService(placement=MeshPlacement(mesh22, word_axis="model", engine="cuda"))
    try:
        wall = {}
        t0 = time.perf_counter()
        svc_mesh.append(svc["table"])
        wall["append_table_s"] = time.perf_counter() - t0
        I.reset_launches()
        t0 = time.perf_counter()
        cold = svc_mesh.mine(tau=1, kmax=4)
        wall["cold_s"] = time.perf_counter() - t0
        if cold.source != "cold" or _value_sets(cold.result) != _value_sets(svc["want"]):
            fail(f"mesh service cold: source {cold.source}")
        part = svc["extra"][:SERVICE_INCREMENTAL_ROWS]
        svc_mesh.append(part)
        t0 = time.perf_counter()
        inc = svc_mesh.mine(tau=1, kmax=4)
        wall["incremental_s"] = time.perf_counter() - t0
        if inc.source != "incremental" or _value_sets(inc.result) != _value_sets(svc["cold_all"]):
            fail(f"mesh service incremental: source {inc.source}")
        launches = {k: v for k, v in I.LAUNCHES.items() if v}
        for k, v in launches.items():
            phase_launches[k] += v
        desc = svc_mesh.placement.describe()
        out["service"] = {**wall, "launches": launches,
                          "launches_per_shard": _shard_counts(svc_mesh.placement, "dispatch"),
                          "placement": {k: desc[k] for k in ("mesh_shape", "distinct_devices",
                                                              "mesh_entries")},
                          "peak_bytes": _peaks()}
        print("  mesh service: " + json.dumps(out["service"]), flush=True)
    finally:
        svc_mesh.close()
    del svc_mesh
    _reset_peaks()
    out["phase_s"] = time.perf_counter() - t_phase
    print("phase mesh: ok " + json.dumps({"dataset": "poker_like(n=1000000, m=10, seed=0)", "tau": 1,
                                          "kmax": 4, **out}), flush=True)
    return phase_launches


# -- phase fleet -------------------------------------------------------------


def _peer_log(log_path: Path) -> tuple[int | None, dict]:
    """The device peak and kernel launches a fleet peer logged after its
    last command."""
    peak, launches = None, {}
    for line in log_path.read_text().splitlines():
        m = re.search(r"fleet peer p\d+ ran \S+ \(\d+ ops, device peak (\w+) bytes, "
                      r"launches (\{[^{}]*\})\)", line)
        if m:
            peak = int(m.group(1)) if m.group(1).isdigit() else None
            launches = json.loads(m.group(2))
    return peak, launches


def _launch_env(log_path: Path) -> dict | None:
    """The launch environment a ``serve_miner`` process logged at startup."""
    m = re.search(r"launch environment (\{[^{}]*\})", log_path.read_text())
    return json.loads(m.group(1)) if m else None


def phase_fleet(device, svc: dict) -> dict:
    """The lockstep fleet: two ``serve_miner`` processes on the card
    (``--num-processes 2``, ``--device cuda:0``, a TCPStore on a free local
    port). Process 0 preloads phase service's CSV, which crosses the command
    bus to process 1 in one append round, and keeps its shadow. Over HTTP:
    a cold mine (tau=1, kmax=4), an append of 1,341 rows and the incremental
    mine, ``/risk``, each equal to phase service's in-process answers;
    ``/stats`` with no degradation and the collective's rounds, seconds and
    payload bytes. Then process 1 is killed with SIGKILL; after another
    append the next mine must come from the shadow, exactly, with
    ``resilience.fleet`` degraded by a ``FleetTimeout``. Returns the
    launches of both processes, added."""
    dev = str(device)
    t_phase = time.perf_counter()
    tmp = svc["tmp"]
    logs = [tmp / "fleet0.log", tmp / "fleet1.log"]
    http_port, coord = _free_port(), _free_port()
    common = ["--device", "cuda:0" if dev.startswith("cuda") else dev, "--num-processes", "2",
              "--coordinator-address", f"127.0.0.1:{coord}", "--fleet-timeout-s", "10"]
    out: dict = {}
    t0 = time.perf_counter()
    procs = [_start_server(http_port, svc["csv"], logs[0], common + ["--process-id", "0"]),
             _start_server(_free_port(), None, logs[1], common + ["--process-id", "1"])]
    try:
        out["preload_s"] = _wait_ready("fleet", procs[0], http_port, logs[0], t0)
        if procs[1].poll() is not None:
            fail("fleet: the peer exited:\n" + logs[1].read_text()[-4000:])

        def ask(label, path, payload=None):
            t = time.perf_counter()
            code, body = _http(http_port, path, payload)
            dt = time.perf_counter() - t
            if code != 200:
                fail(f"fleet {label}: HTTP {code}: {body}")
            out[f"{label}_s"] = dt
            return body

        st = ask("stats_after_preload", "/stats")
        out["preload_rounds"] = st["resilience"]["fleet"]["collective"]
        cold = ask("cold", "/mine?tau=1&kmax=4")
        if cold["source"] != "cold" or _value_sets_json(cold) != _value_sets(svc["want"]):
            fail(f"fleet cold: source {cold['source']}, {cold['n_itemsets']} itemsets")
        st = ask("stats_after_cold", "/stats")
        fl = st["resilience"]["fleet"]
        if fl["degraded"] or fl["nproc"] != 2:
            fail(f"fleet: degraded after the cold mine: {fl}")
        out["cold_levels"] = st["placement"]["level_reduces"]
        out["cold_collective"] = fl["collective"]
        launches = st["launches"]["intersect"]
        if not launches["intersect_write_indexed"] or not launches["intersect_count_indexed"] or \
                launches["intersect_classify_write_indexed"] or launches["intersect_classify_count_indexed"]:
            fail(f"fleet: the cold mine must launch the unfused kernels only: {launches}")
        print(f"  fleet: ready after {out['preload_s']:.2f} s (1,000,000 rows, the bus append included); "
              f"cold mine {out['cold_s']:.3f} s against phase service's {svc['plain_cold_s']:.3f} s; "
              f"all-reduces per level {json.dumps(out['cold_levels'])}", flush=True)

        part = svc["extra"][:SERVICE_INCREMENTAL_ROWS]
        ask("append", "/append", {"rows": part.tolist()})
        inc = ask("incremental", "/mine?tau=1&kmax=4")
        if inc["source"] != "incremental" or _value_sets_json(inc) != _value_sets(svc["cold_all"]):
            fail(f"fleet incremental: source {inc['source']}, {inc['n_itemsets']} itemsets")
        risk = ask("risk", "/risk?tau=1&kmax=4")
        drop = ("version", "source", "latency_s", "trace_id")
        if {k: v for k, v in risk.items() if k not in drop} != svc["risk"]:
            fail("fleet risk: differs from phase service's in-process risk profile")
        st = ask("stats_healthy", "/stats")
        fl = st["resilience"]["fleet"]
        if fl["degraded"] or fl["collective"]["rounds"] <= 0:
            fail(f"fleet: {fl}")
        all_launches = {k: v for fam in st["launches"].values() for k, v in fam.items() if v}
        if not sum(st["launches"]["coverage"].values()):
            fail(f"fleet: /risk launched no coverage kernel: {st['launches']}")
        out["healthy"] = {"collective": fl["collective"], "replicated_ops": fl["replicated_ops"],
                          "p0_peak_bytes": fl["device_peak_bytes"], "launches_p0": all_launches}
        print(f"  fleet: incremental {out['incremental_s']:.3f} s, risk {out['risk_s']:.3f} s; "
              + json.dumps(out["healthy"]), flush=True)

        # a peer dies: the next replicated op times out and the shadow answers
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=60)
        # the peer logs after each command; read once it can write no more
        peak1, launches1 = _peer_log(logs[1])
        if not launches1.get("intersect_write_indexed") or \
                not launches1.get("intersect_count_indexed") or \
                not launches1.get("coverage_accumulate_indexed", 0) + launches1.get(
                    "coverage_accumulate_anchored", 0):
            fail(f"fleet: the peer did not launch rows 3-4 and a coverage kernel: {launches1}")
        out["healthy"].update({"p1_peak_bytes": peak1, "launches_p1": launches1,
                               "launch_env": [_launch_env(log) for log in logs]})
        print("  fleet: peer p1 " + json.dumps({k: out["healthy"][k] for k in
                                                ("p1_peak_bytes", "launches_p1", "launch_env")}),
              flush=True)
        more = svc["extra"][SERVICE_INCREMENTAL_ROWS : SERVICE_INCREMENTAL_ROWS + 100]
        t0 = time.perf_counter()
        ask("append_after_kill", "/append", {"rows": more.tolist()})
        after = ask("mine_after_kill", "/mine?tau=1&kmax=4")
        out["degrade_s"] = time.perf_counter() - t0
        st = ask("stats_degraded", "/stats")
        fl = st["resilience"]["fleet"]
        if not fl["degraded"] or "FleetTimeout" not in (fl["degraded_reason"] or ""):
            fail(f"fleet: not degraded by a FleetTimeout after the kill: {fl}")
        if st["placement"].get("engine") != "cuda" or st["placement"].get("backend") != "cuda":
            fail(f"fleet: the shadow does not mine on the card: {st['placement']}")
        from repro_torch.core import KyivConfig, prepare
        from repro_torch.core.kyiv import mine_preprocessed

        rows = np.concatenate([svc["table"], part, more])
        cfg = KyivConfig(tau=1, kmax=4, engine="cuda", device=dev)
        want = mine_preprocessed(prepare(rows, cfg), cfg)
        if _value_sets_json(after) != _value_sets(want):
            fail(f"fleet: the shadow's answer after the kill differs ({after['n_itemsets']} itemsets "
                 f"against {len(want.itemsets)})")
        # process 0's allocator peak now includes its shadow's cold mine
        out["degraded"] = {"reason": fl["degraded_reason"][:120], "source": after["source"],
                           "p0_peak_bytes": fl["device_peak_bytes"]}
        print(f"  fleet: peer killed; append + mine answered by the shadow in {out['degrade_s']:.3f} s "
              f"(--fleet-timeout-s 10); " + json.dumps(out["degraded"]), flush=True)
        _stop_server("fleet", procs[0], logs[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["phase_s"] = time.perf_counter() - t_phase
    print("phase fleet: ok " + json.dumps({"dataset": "poker_like(n=1000000, m=10, seed=0) via CSV",
                                           "processes": 2, "tau": 1, "kmax": 4, **out}), flush=True)
    both = dict(out["healthy"]["launches_p0"])
    for k, v in out["healthy"]["launches_p1"].items():
        both[k] = both.get(k, 0) + v
    return both


# -- phase coverage-kernel -------------------------------------------------


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


def phase_coverage_kernel(device, table_bits, qi3, rates, poker_res):
    """Both coverage kernels against the plain versions over the sweep,
    then timed at the privacy path's batch: the table's padded width, K = 3
    and the bucket of a full batch (W = 15,628 and M = 8,192, the bucket of
    4,294 sets, for 500,000 rows). On the sparse batch of real QIs both
    kernels run (the dispatch picks the anchored one); on the dense batch of
    random rows the scanning one (the dispatch's pick). The index of the
    table is built and timed here. Last, the batches the main path really
    gives the dispatch on the Poker-hand table: phase 3's quasi-identifiers
    by size, padded as ``CoverageEngine`` pads them (edge rows of weight 0
    up to the bucket), each timed with the kernel the dispatch picks."""
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
    poker = _poker_profile_batches(device, poker_res, rates)
    print("phase coverage-kernel: ok " + json.dumps({
        "checks": checks, "max_abs_err": err, "batch_cap": cap, "index": index_info,
        "sparse": {"inputs": f"the first {cap} size-3 QIs of the exposed table, "
                             f"padded to {bucket} with weight 0", ANCHORED: sparse, COVERAGE: sparse_scan,
                   "scan_over_anchored": sparse_scan["graph_ms"] / sparse["graph_ms"],
                   "scan_over_anchored_calls": sparse_scan["kernel_ms"] / sparse["kernel_ms"]},
        "dense": {"inputs": "512 random rows, random sets, weight 1", **dense},
        "poker": poker,
    }), flush=True)
    return {"max_abs_err": err, "sparse": sparse, "sparse_scan": sparse_scan, "dense": dense,
            "poker": poker}


def _poker_profile_batches(device, poker_res, rates) -> list[dict]:
    """The Poker-hand mine's risk-profile batches (its QIs grouped by size,
    padded to the bucket with edge rows of weight 0), each held against the
    plain versions and timed with the kernel the dispatch picks for it."""
    from repro_torch.core.bitops import device_bits
    from repro_torch.kernels.coverage import anchored_plan, build_coverage_index
    from repro_torch.kernels.intersect import next_bucket

    bits = device_bits(poker_res.prep.table.bits, device)
    index = build_coverage_index(bits)
    by_size: dict[int, list] = {}
    for ids, _ in poker_res.itemsets:
        by_size.setdefault(len(ids), []).append(ids)
    out = []
    for k, sets in sorted(by_size.items()):
        m = len(sets)
        bucket = next_bucket(m)
        chunk = np.pad(np.asarray(sets, dtype=np.int32), ((0, bucket - m), (0, 0)), mode="edge")
        wchunk = np.pad(np.ones(m, dtype=np.int32), (0, bucket - m))
        anchored = anchored_plan(index.counts, chunk, wchunk, bits.shape[1])[0]
        sets_d, wt_d = torch.from_numpy(chunk).to(device), torch.from_numpy(wchunk).to(device)
        idx = index if anchored else None
        bound = _coverage_bound(bits, sets_d, wt_d, rates, idx)
        out.append({"K": k, "qis": m, **_time_coverage(f"poker K={k}", bits, sets_d, wt_d, bound, idx)})
    del bits, index
    torch.cuda.empty_cache()
    return out


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


LM_ARCH = "gemma3-4b"
LM_CHECK_B, LM_CHECK_S, LM_CHECK_STEPS = 2, 1_536, 8  # S over gemma3's 1,024 window: rings
LM_SERVE = dict(batch=8, prompt_len=2_048, max_new=64)
LM_CARD_TOL = 1e-4  # reduced, float32: card against CPU (sums in other orders)
LM_DECODE_TOL = 2e-3  # full width, float32: decode against the full forward (the reference's test)
# full width, bf16: decode against the full forward. Both round every
# activation to bf16 (8 significant bits) but sum in other orders; logits
# reach about 10, where a bf16 ulp is 0.0625, so 0.25 is four ulps there
LM_BF16_TOL = 0.25
LM_PLANT_STEPS = 4  # decode steps of each planted fault's run
# faults planted in the caches or positions a correct decode gets; each must
# break the float32 limit, or it could not see a wrong cache. The bf16 limit
# must see the wrong ring; a one-position slip moves bf16 logits (0.17 on an
# H100) about as much as two correct bf16 paths differ (0.12), so there only
# the float32 check, which runs the same code, holds it
LM_FAULTS = ("ring_oldest", "position_early")
LM_BF16_SEES = ("ring_oldest",)


def _lm_batch(cfg, b: int, s: int, seed: int) -> dict:
    from repro_torch.launch.serve import make_batch

    return make_batch(cfg, np.random.default_rng(seed), b, s)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cache_leaves(cache) -> list:
    if isinstance(cache, dict):
        return _cache_leaves(cache["self"]) + _cache_leaves(cache["cross"])
    return [v for st in cache for _, v in sorted(st.items())]


def _lm_reduced(device) -> float:
    """The ten reduced architectures on the card against the port on the CPU,
    same weights, float32: prefill and 8 decode steps, logits and caches."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.zoo import build
    from repro_torch.serving.engine import prefill_then_decode

    worst = 0.0
    for name in sorted(ARCHS):
        cfg = reduced(ARCHS[name])
        model = build(cfg)
        cpu_net = model.init(torch.Generator().manual_seed(0))
        card_net = model.load({k: v.to(device) for k, v in cpu_net.state_dict().items()})
        batch = _lm_batch(cfg, 2, 20 + 8, seed=1)
        want, want_cache = prefill_then_decode(model, cpu_net, batch, 20, 8)
        got, got_cache = prefill_then_decode(model, card_net, batch, 20, 8)
        pairs = [(got, want)] + list(zip(_cache_leaves(got_cache), _cache_leaves(want_cache),
                                         strict=True))
        for g, w in pairs:
            g, w = g.float().cpu(), w.float()
            if g.shape != w.shape or not torch.allclose(g, w, rtol=LM_CARD_TOL, atol=LM_CARD_TOL):
                fail(f"phase lm: reduced {name} on the card differs from the CPU "
                     f"(max_abs_err {float((g - w).abs().max()):.3g})")
            worst = max(worst, float((g - w).abs().max()))
    return worst


def _planted(model, fault: str):
    """``model`` with a fault planted where a decode reads its state:
    ``ring_oldest`` lays each local layer's ring out from the prompt's first
    window of positions, not its last; ``position_early`` decodes every step
    one position early (the previous token's cache entry is overwritten and
    RoPE is off by one)."""
    base = type(model)
    window = model.cfg.window

    class Planted(base):
        def prefill(self, net, batch):
            logits, cache = base.prefill(self, net, batch)
            if fault == "ring_oldest":
                _, oldest = base.prefill(self, net, dict(batch, tokens=batch["tokens"][:, :window]))
                cache = [o if st["k"].shape[1] == window else st for st, o in zip(cache, oldest)]
            return logits, cache

        def decode(self, net, batch, cache):
            if fault == "position_early":
                batch = dict(batch, positions=batch["positions"] - 1)
            return base.decode(self, net, batch, cache)

    return Planted(model.cfg)


def _lm_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    d = (got.float() - want).abs()
    return {"max_abs_err": float(d.max()), "rms_err": float(d.square().mean().sqrt()),
            "finite": bool(torch.isfinite(got).all())}


def _lm_decode_check(model, net, batch, s: int, steps: int, want: torch.Tensor) -> tuple:
    """Teacher-forced decode of ``batch`` from ``s`` against the full
    forward's logits ``want`` (B, steps + 1, V), then each planted fault's
    decode over ``LM_PLANT_STEPS``. Returns (the decode's logits on the card,
    its errors, {fault: errors}); ``_lm_judge`` holds them to a limit."""
    from repro_torch.serving.engine import prefill_then_decode

    got, cache = prefill_then_decode(model, net, batch, s, steps)
    del cache
    planted = {}
    for fault in LM_FAULTS:
        bad, cache = prefill_then_decode(_planted(model, fault), net, batch, s, LM_PLANT_STEPS)
        del cache
        planted[fault] = _lm_errors(bad, want[:, :LM_PLANT_STEPS + 1])
    return got, _lm_errors(got, want), planted


def _lm_judge(what: str, errs: dict, planted: dict, tol: float, sees=LM_FAULTS) -> None:
    """The decode's max_abs_err within ``tol``; each planted fault of
    ``sees`` over it."""
    if not errs["finite"] or errs["max_abs_err"] > tol:
        fail(f"phase lm: {what} decode differs from the forward (max_abs_err "
             f"{errs['max_abs_err']:.4g}, limit {tol})")
    for fault in sees:
        if planted[fault]["max_abs_err"] <= tol:
            fail(f"phase lm: {what} limit {tol} does not see the planted fault {fault} "
                 f"(max_abs_err {planted[fault]['max_abs_err']:.4g})")


def _lm_full_width_check(device) -> dict:
    """gemma3-4b at full width and depth in float32: prefill of 1,536 tokens
    (local caches become rings) and 8 decode steps against the full forward,
    and the planted faults against the same limit."""
    import dataclasses as dc

    from repro_torch.configs import ARCHS
    from repro_torch.models.zoo import build
    from repro_torch.serving.engine import prefill_then_decode

    cfg = dc.replace(ARCHS[LM_ARCH], dtype="float32")
    model = build(cfg)
    t0 = time.perf_counter()
    net = model.init(torch.Generator(device).manual_seed(0), device)
    _sync(device)
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in net.parameters())
    batch = _lm_batch(cfg, LM_CHECK_B, LM_CHECK_S + LM_CHECK_STEPS, seed=2)
    t0 = time.perf_counter()
    _, cache = prefill_then_decode(model, net, batch, LM_CHECK_S, 0)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    rings = sorted({tuple(st["k"].shape) for st in cache})
    want_shapes = [(LM_CHECK_B, cfg.window, cfg.n_kv_heads, cfg.head_dim),
                   (LM_CHECK_B, LM_CHECK_S, cfg.n_kv_heads, cfg.head_dim)]
    if rings != want_shapes:
        fail(f"phase lm: full-width cache shapes {rings}, want {want_shapes}")
    del cache
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = model.forward(net, {k: v.to(device) for k, v in batch.items()},
                             positions=slice(LM_CHECK_S - 1, None)).float()
    _sync(device)
    forward_s = time.perf_counter() - t0
    _, errs, planted = _lm_decode_check(model, net, batch, LM_CHECK_S, LM_CHECK_STEPS, want)
    del net, want
    torch.cuda.empty_cache()
    print(f"phase lm: float32 decode == forward {errs} (limit {LM_DECODE_TOL}); planted faults "
          f"{planted}", flush=True)
    _lm_judge("full-width float32", errs, planted, LM_DECODE_TOL)
    return {"init_s": init_s, "weight_gb": weight_bytes / 1e9, "prefill_s": prefill_s,
            "forward_s": forward_s, "max_abs_err": errs["max_abs_err"], "planted": planted}


def _lm_step_bytes(batch: int, ctx: int) -> tuple[int, int]:
    """Bytes one bf16 decode step of gemma3-4b must read: every weight once
    (the tied embedding is the head) and every KV cache at ``ctx`` slots."""
    import dataclasses as dc

    from repro_torch.configs import ARCHS
    from repro_torch.models.layers.common import F32_LEAVES
    from repro_torch.models.zoo import build

    cfg = dc.replace(ARCHS[LM_ARCH], dtype="bfloat16")
    model = build(cfg)
    weights = sum(p.numel() * (4 if n.rsplit(".", 1)[-1] in F32_LEAVES else 2)
                  for n, p in model.abstract_params().named_parameters())
    caches = sum(v.numel() * v.element_size()
                 for st in model.init_cache(batch, ctx, device="meta") for v in st.values())
    return weights, caches


LM_PROFILE_STEPS = 4


def _lm_decode_profile(model, net, prompts, first) -> dict:
    """``torch.profiler`` over ``LM_PROFILE_STEPS`` decode steps after a
    prefill: the window's wall time (ending in a sync; the profiler's own
    host cost included), the device's busy time (kernels, copies and fills
    on the one stream) and the device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import grow_cache

    device = torch.device("cuda", 0)
    b, s = prompts.shape
    _, cache = model.prefill(net, {"tokens": prompts.to(device)})
    cache = grow_cache(cache, s, s + LM_PROFILE_STEPS)
    tok = first.to(device)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(LM_PROFILE_STEPS):
            dec = {"tokens": tok, "positions": torch.full((b,), s + i, device=device)}
            logits, cache = model.decode(net, dec, cache)
            tok = logits[:, 0].argmax(dim=-1)[:, None]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    # CUPTI's marker of the host blocked on a full launch queue: not device work
    host_wait_ms = by_name.pop("Command Buffer Full", (0.0, 0))[0]
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms > wall_ms:
        fail(f"phase lm: the profile counts {busy_ms:.3f} ms of device time in a "
             f"{wall_ms:.3f} ms window: events overlap or are counted twice")
    del cache
    return {"steps": LM_PROFILE_STEPS, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "host_wait_ms": host_wait_ms, "idle_share_profiled": 1.0 - busy_ms / wall_ms,
            "launches": sum(n for _, n in by_name.values()),
            "top": sorted(((ms, n, name) for name, (ms, n) in by_name.items()), reverse=True)[:6]}


def _lm_serve_inproc() -> dict:
    """``serve``'s run in this process (``launch.serve.prepare`` and
    ``generate``: the same seed and arguments as the CLI), a profile of its
    decode, then the bf16 decode's logits over the generated tokens against
    the bf16 full forward's, and the planted faults against the same limit.
    The teacher-forced decode's argmax must give ``generate``'s tokens."""
    from repro_torch.launch.serve import prepare
    from repro_torch.serving.engine import generate

    device = torch.device("cuda", 0)
    s, new = LM_SERVE["prompt_len"], LM_SERVE["max_new"]
    model, net, prompts, extra = prepare(LM_ARCH, batch=LM_SERVE["batch"], prompt_len=s)
    torch.cuda.reset_peak_memory_stats(device)
    gen = generate(model, net, prompts, max_new=new, extra=extra)
    peak = torch.cuda.max_memory_allocated(device)
    prof = _lm_decode_profile(model, net, prompts, gen.tokens[:, 0])
    prof["step_ms_median"] = float(np.median(gen.step_s)) * 1e3
    prof["idle_share"] = 1.0 - prof["busy_ms"] / prof["steps"] / prof["step_ms_median"]
    batch = {"tokens": torch.cat([prompts, gen.tokens[:, :-1]], dim=1)}
    with torch.inference_mode():
        want = model.forward(net, {"tokens": batch["tokens"].to(device)},
                             positions=slice(s - 1, None)).float()
    got, errs, planted = _lm_decode_check(model, net, batch, s, new - 1, want)
    print(f"phase lm: bf16 decode == forward {errs} (limit {LM_BF16_TOL}, must see "
          f"{LM_BF16_SEES}); planted faults {planted}", flush=True)
    _lm_judge("full-width bf16", errs, planted, LM_BF16_TOL, sees=LM_BF16_SEES)
    top2 = want.topk(2, dim=-1).values
    check = {**errs, "planted": planted,
             "min_margin": float((top2[..., 0] - top2[..., 1]).min()),
             "decode_argmax_is_generate": bool((got.argmax(dim=-1).cpu() == gen.tokens).all())}
    del net, want, got, top2
    torch.cuda.empty_cache()
    wall = gen.prefill_s + gen.decode_s
    return {"tokens": gen.tokens.tolist(), "prefill_s": gen.prefill_s, "decode_step_s": gen.step_s,
            "decode_step_median_s": float(np.median(gen.step_s)),
            "tokens_per_s": gen.tokens.numel() / wall, "peak_bytes": peak,
            "profile": prof, "check": check}


def phase_lm(device) -> dict:
    """The LM scaffold's serving path: reduced architectures card against CPU,
    gemma3-4b's full-width decode check, then its serve CLI in bfloat16."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase lm: TF32 matmuls are on; the port never enables them")
    worst = _lm_reduced(device)
    print(f"phase lm: reduced ok archs=10 prefill+8 decode steps card==cpu "
          f"max_abs_err={worst:.3g} (tol {LM_CARD_TOL}) s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    t0 = time.perf_counter()
    full = _lm_full_width_check(device)
    print(f"phase lm: full-width ok {LM_ARCH} float32 weights={full['weight_gb']:.2f}GB "
          f"B={LM_CHECK_B} S={LM_CHECK_S} 8 decode steps==forward "
          f"max_abs_err={full['max_abs_err']:.3g} (tol {LM_DECODE_TOL}) "
          f"init_s={full['init_s']:.2f} prefill_s={full['prefill_s']:.3f} "
          f"forward_s={full['forward_s']:.3f} s={time.perf_counter() - t0:.1f}", flush=True)

    out_json = ROOT / "build" / "lm_serve.json"
    out_json.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_ARCH,
           "--batch", str(LM_SERVE["batch"]), "--prompt-len", str(LM_SERVE["prompt_len"]),
           "--max-new", str(LM_SERVE["max_new"]), "--out", str(out_json)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=str(ROOT), env=env)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase lm: serve CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    rec = json.loads(out_json.read_text())
    out_json.unlink()
    if rec["device"] != "cuda" or rec["dtype"] != "bfloat16":
        fail(f"phase lm: serve CLI ran on {rec['device']} in {rec['dtype']}")
    inproc = _lm_serve_inproc()
    weights, caches = _lm_step_bytes(LM_SERVE["batch"],
                                     LM_SERVE["prompt_len"] + LM_SERVE["max_new"])
    bound_ms = (weights + caches) / HBM_BYTES_PER_S * 1e3
    out = {}
    for label, r in (("cli", rec), ("inproc", inproc)):
        steps = sorted(r["decode_step_s"])
        out[label] = {"prefill_s": r["prefill_s"], "step_ms_median": r["decode_step_median_s"] * 1e3,
                      "step_ms_min": steps[0] * 1e3, "step_ms_max": steps[-1] * 1e3,
                      "tokens_per_s": r["tokens_per_s"], "peak_gb": r["peak_bytes"] / 1e9}
    for label, o in out.items():
        print(f"phase lm: serve {label} {LM_ARCH} bf16 B={LM_SERVE['batch']} "
              f"S={LM_SERVE['prompt_len']} new={LM_SERVE['max_new']} "
              f"prefill_s={o['prefill_s']:.4f} decode_step_ms median={o['step_ms_median']:.3f} "
              f"range=[{o['step_ms_min']:.3f},{o['step_ms_max']:.3f}] "
              f"tokens_per_s={o['tokens_per_s']:.1f} peak_gb={o['peak_gb']:.2f} "
              f"step_bound_ms={bound_ms:.3f} (weights {weights / 1e9:.2f}GB + caches "
              f"{caches / 1e9:.2f}GB over 3.35TB/s)", flush=True)
    prof = inproc["profile"]
    print(f"phase lm: profile of {prof['steps']} decode steps: wall {prof['wall_ms']:.3f} ms, "
          f"device busy {prof['busy_ms']:.3f} ms (idle share {prof['idle_share_profiled']:.3f} "
          f"of the profiled window; {prof['idle_share']:.3f} of the unprofiled median step "
          f"{prof['step_ms_median']:.3f} ms), {prof['launches']} device operations, host "
          f"blocked on a full launch queue {prof['host_wait_ms']:.3f} ms; by time: "
          + "; ".join(f"{name[:48]} {ms:.3f} ms x{n}" for ms, n, name in prof["top"]),
          flush=True)
    check = inproc["check"]
    tokens = rec["tokens"]
    print(f"phase lm: the forward's min top-2 margin over the generated tokens "
          f"{check['min_margin']:.4g}; distinct tokens per row {[len(set(row)) for row in tokens]}",
          flush=True)
    if inproc["tokens"] != tokens:
        fail("phase lm: the serve CLI's tokens differ from an in-process generate of one seed")
    if not check["decode_argmax_is_generate"]:
        fail("phase lm: the teacher-forced decode's argmax is not generate's tokens")
    out.update(full=full, reduced_max_abs_err=worst, bound_ms=bound_ms, cli_s=cli_s,
               phase_s=time.perf_counter() - t_phase)
    print(f"phase lm: ok tokens equal (CLI subprocess == in-process) cli_s={cli_s:.1f} "
          f"phase_s={out['phase_s']:.1f}", flush=True)
    return out


TRAIN_ARCH = "granite-moe-1b-a400m"
# lr: OptConfig's default. The CLI's default (3e-3, the reference's, for the
# reduced configs) with its one warmup step makes the full-width losses bounce
# (PERF.md, PR 21)
TRAIN_FULL = dict(steps=8, batch=8, seq=2_048, lr=3e-4)
TRAIN_RESUME_ARCH = "glm4-9b"
TRAIN_B, TRAIN_S = 2, 20  # the reduced steps' batch
TRAIN_STEP_TOL = 1e-4  # of a leaf's largest |m| or |v| (tests/test_torch_train_rule.py)
TRAIN_FLIP_SHARE = 1e-3  # most entries that may differ by a bf16 ulp of the gradient
BF16_ULP = 2.0 ** -7
# NVIDIA's data sheet: H100 SXM dense bf16 tensor-core peak, 989e12 (cited, not measured)
BF16_PEAK_FLOPS = H100.peak_bf16_flops


def _train_batch(cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = _lm_batch(cfg, b, s, seed)
    labels = rng.integers(0, cfg.vocab, (b, s))
    labels[0, :3] = -1
    batch["labels"] = torch.from_numpy(labels)
    return batch


def _moments_close(got: dict, want: dict, what: str, ulps: float, phase: str = "train",
                   dev="cpu") -> int:
    """Each leaf within TRAIN_STEP_TOL of its largest |want|, except at no
    more than TRAIN_FLIP_SHARE of the entries, which may differ by ``ulps``
    bf16 ulps of the leaf's largest more: a gradient term that two devices
    sum in other orders can round to the neighbouring bf16 value, and a
    gradient may be a sum of such terms (a tied embedding's gather and
    head). Compared leaf by leaf on ``dev``. Returns that count."""
    flips = total = 0
    for name, w in want.items():
        g = got[name].detach().to(dev, torch.float32)
        w = w.detach().to(dev, torch.float32)
        d = (g - w).abs()
        tol = TRAIN_STEP_TOL * float(w.abs().max())
        over = d > tol
        flips += int(over.sum())
        total += d.numel()
        if (over & (d > ulps * BF16_ULP * float(w.abs().max()) + tol)).any():
            fail(f"phase {phase}: {what} {name} differs beyond one bf16 ulp "
                 f"(max {float(d.max()):.3g})")
    if flips > TRAIN_FLIP_SHARE * total:
        fail(f"phase {phase}: {what}: {flips} of {total} entries differ by a bf16 ulp")
    return flips


def _adam_dir(m, v, step: int, cfg) -> torch.Tensor:
    """AdamW's direction m^ / (sqrt(v^) + eps) after ``step`` steps, float64."""
    m, v = m.detach().double() / (1 - cfg.b1 ** step), v.detach().double() / (1 - cfg.b2 ** step)
    return m / (v.sqrt() + cfg.eps)


def _adam_direction(opt: dict, name: str, cfg) -> torch.Tensor:
    """AdamW's first-step direction, in float64 on the CPU."""
    return _adam_dir(opt["m"][name].cpu(), opt["v"][name].cpu(), 1, cfg)


def _train_reduced(device) -> dict:
    """The ten reduced architectures: one float32 step (cast_bf16) on the
    card against the same step on the CPU, from the same weights."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.zoo import build
    from repro_torch.training import OptConfig, adamw_init, make_train_step

    opt_cfg = OptConfig(warmup_steps=1)
    worst = {"loss": 0.0, "grad_norm": 0.0, "param": 0.0, "flips": 0, "moved": 0}
    for name in sorted(ARCHS):
        cfg = reduced(ARCHS[name])
        model = build(cfg)
        cpu_net = model.init(torch.Generator().manual_seed(0))
        card_net = model.load({k: v.to(device, copy=True)
                               for k, v in cpu_net.state_dict().items()})
        batch = _train_batch(cfg, TRAIN_B, TRAIN_S, seed=3)
        step = make_train_step(model, opt_cfg)
        out = {}
        for label, net in (("cpu", cpu_net), ("card", card_net)):
            dev = next(net.parameters()).device
            opt = adamw_init(dict(net.named_parameters()))
            opt, met = step(net, opt, {k: v.to(dev) for k, v in batch.items()})
            out[label] = (net, opt, {k: float(v) for k, v in met.items()})
        (cn, co, cm), (gn, go, gm) = out["cpu"], out["card"]
        if next(gn.parameters()).device.type != device.type:
            fail(f"phase train: reduced {name} did not step on {device}")
        d_loss = abs(gm["loss"] - cm["loss"])
        d_gn = abs(gm["grad_norm"] - cm["grad_norm"]) / cm["grad_norm"]
        if d_loss > 1e-5 or d_gn > 1e-5 or gm["lr"] != cm["lr"]:
            fail(f"phase train: reduced {name}: card {gm} against cpu {cm}")
        worst["flips"] += _moments_close(go["m"], co["m"], f"{name} m", 1)
        worst["flips"] += _moments_close(go["v"], co["v"], f"{name} v", 2)
        gp, cp = dict(gn.named_parameters()), dict(cn.named_parameters())
        for n, w in cp.items():
            # each side's update from its own moments: where a gradient at
            # float noise (near eps, or a leaf whose exact gradient is zero)
            # differs, AdamW's direction may swing by up to 2
            d = gp[n].detach().cpu().double() - w.detach().double()
            pred = -gm["lr"] * (_adam_direction(go, n, opt_cfg) - _adam_direction(co, n, opt_cfg))
            if ((d - pred).abs() > 1e-6).any() or (d.abs() > 2 * opt_cfg.lr).any():
                fail(f"phase train: reduced {name} param {n} differs by "
                     f"{float((d - pred).abs().max()):.3g} from its moments' update")
            worst["moved"] += int((d.abs() > 1e-6).sum())
            worst["param"] = max(worst["param"], float((d - pred).abs().max()))
        worst["loss"] = max(worst["loss"], d_loss)
        worst["grad_norm"] = max(worst["grad_norm"], d_gn)
    return worst


def _train_cli(args: list[str], out_json: Path) -> dict:
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args, "--out", str(out_json)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=str(ROOT),
                          env=env)
    if proc.returncode != 0:
        fail(f"phase train: {' '.join(args)} exited {proc.returncode}: {proc.stderr[-3000:]}")
    rec = json.loads(out_json.read_text())
    out_json.unlink()
    return rec


def _train_flop_bound_ms(cfg, batch: int, seq: int) -> tuple[float, float]:
    """(FLOPs, ms) of one step's least work at the bf16 peak: 6 x active
    parameters x tokens, plus causal attention's scores and weighted sums
    (forward 2 B S^2 H hd per layer, backward twice that)."""
    tokens = batch * seq
    dense = 6 * cfg.active_param_count() * tokens
    attn = 6 * cfg.n_layers * batch * seq * seq * cfg.n_heads * cfg.head_dim
    flops = dense + attn
    return flops, flops / BF16_PEAK_FLOPS * 1e3


def _train_full_width(work: Path) -> dict:
    from repro_torch.configs import ARCHS

    cfg = ARCHS[TRAIN_ARCH]
    rec = _train_cli(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_FULL["steps"]),
                      "--batch", str(TRAIN_FULL["batch"]), "--seq", str(TRAIN_FULL["seq"]),
                      "--lr", str(TRAIN_FULL["lr"]), "--log-every", "1"], work / "full.json")
    losses = rec["losses"]
    if rec["device"] == "cpu" or rec["dtype"] != "bfloat16" or len(losses) != TRAIN_FULL["steps"]:
        fail(f"phase train: full-width run on {rec['device']} in {rec['dtype']}, "
             f"{len(losses)} steps")
    if not all(np.isfinite(losses)):
        fail(f"phase train: non-finite loss {losses}")
    if not (losses[-1] + losses[-2]) / 2 < losses[0]:
        fail(f"phase train: the loss does not fall: {losses}")
    warm = sorted(rec["step_s"][1:])
    flops, bound_ms = _train_flop_bound_ms(cfg, TRAIN_FULL["batch"], TRAIN_FULL["seq"])
    median_ms = float(np.median(warm)) * 1e3
    return {"losses": losses, "ln_vocab": float(np.log(cfg.vocab)), "step_ms_median": median_ms, "step_ms_min": warm[0] * 1e3,
            "step_ms_max": warm[-1] * 1e3, "step0_ms": rec["step_s"][0] * 1e3,
            "tokens_per_s": TRAIN_FULL["batch"] * TRAIN_FULL["seq"] / (median_ms / 1e3),
            "tokens_per_s_all": rec["tokens_per_s"], "peak_gb": rec["peak_bytes"] / 1e9,
            "params": cfg.param_count(), "active_params": cfg.active_param_count(),
            "flops": flops, "bound_ms": bound_ms, "bound_share": bound_ms / median_ms}


def _train_profile(device, arch: str | None = None) -> dict:
    """``torch.profiler`` over one warm full-width train step in this
    process (after one unprofiled step): the window's wall time (ending in
    a sync), the device's busy time, and the device time by operator
    (self time of each aten op) and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models.zoo import build
    from repro_torch.training import OptConfig, init_train_state, make_train_step

    cfg = ARCHS[arch or TRAIN_ARCH]
    model = build(cfg)
    opt_cfg = OptConfig(lr=TRAIN_FULL["lr"], warmup_steps=1, total_steps=TRAIN_FULL["steps"])
    net, opt = init_train_state(model, torch.Generator(device).manual_seed(0), opt_cfg, device)
    step = make_train_step(model, opt_cfg)
    stream = synthetic_lm_batches(cfg.vocab, TRAIN_FULL["batch"], TRAIN_FULL["seq"], 0)
    opt, met = step(net, opt, {k: v.to(device) for k, v in next(stream).items()})
    batch = {k: v.to(device) for k, v in next(stream).items()}
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt, met = step(net, opt, batch)
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    kernels.pop("Command Buffer Full", None)
    busy_ms = sum(ms for ms, _ in kernels.values())
    ops = sorted(((a.self_device_time_total / 1e3, a.count, a.key) for a in prof.key_averages()
                  if a.key.startswith("aten::") and a.self_device_time_total > 0), reverse=True)
    del net, opt, met, batch
    torch.cuda.empty_cache()
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "launches": sum(n for _, n in kernels.values()), "ops": ops[:10],
            "kernels": sorted(((ms, n, name) for name, (ms, n) in kernels.items()),
                              reverse=True)[:6]}


def _train_resume(work: Path) -> dict:
    """The CLI at a reduced config on the card: 6 steps with checkpoints at
    3 and 6, then a run stopped after step 3 (step 6's checkpoint removed)
    and resumed; the resumed losses must equal the uninterrupted run's."""
    base = ["--arch", TRAIN_RESUME_ARCH, "--reduced", "--steps", "6", "--ckpt-every", "3",
            "--batch", "4", "--seq", "32", "--log-every", "1"]
    full = _train_cli([*base, "--ckpt-dir", str(work / "full")], work / "a.json")
    part_dir = work / "part"
    _train_cli([*base, "--ckpt-dir", str(part_dir)], work / "b.json")
    shutil.rmtree(part_dir / "ckpt_0000000006")
    resumed = _train_cli([*base, "--ckpt-dir", str(part_dir), "--resume"], work / "c.json")
    if resumed["start_step"] != 3 or resumed["device"] == "cpu":
        fail(f"phase train: resumed from step {resumed['start_step']} on {resumed['device']}")
    if resumed["losses"] != full["losses"][3:]:
        fail(f"phase train: resumed losses {resumed['losses']} != {full['losses'][3:]}")
    return {"losses": full["losses"], "resumed": resumed["losses"]}


def phase_train(device) -> dict:
    """Training on one device: the reduced steps card against CPU,
    granite-moe-1b-a400m at full width through the train CLI, and a resumed
    CLI run."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase train: TF32 matmuls are on; the port never enables them")
    worst = _train_reduced(device)
    print(f"phase train: reduced ok archs=10 one float32 step (cast_bf16) card==cpu "
          f"loss_err={worst['loss']:.3g} grad_norm_rel_err={worst['grad_norm']:.3g} "
          f"param_err={worst['param']:.3g} (tol 1e-6 after each side's own moments' update) "
          f"moment entries at one bf16 ulp {worst['flips']}, param entries apart by more than "
          f"1e-6 {worst['moved']} "
          f"s={time.perf_counter() - t_phase:.1f}", flush=True)
    work = ROOT / "build" / "smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    full = _train_full_width(work)
    full_s = time.perf_counter() - t0
    print(f"phase train: full-width {TRAIN_ARCH} bf16 activations over float32 masters "
          f"params={full['params']:,} active={full['active_params']:,} "
          f"B={TRAIN_FULL['batch']} S={TRAIN_FULL['seq']} losses={full['losses']} "
          f"(first {full['losses'][0]:.4f} beside ln V = {full['ln_vocab']:.2f}) "
          f"step_ms median={full['step_ms_median']:.1f} range=[{full['step_ms_min']:.1f},"
          f"{full['step_ms_max']:.1f}] step0_ms={full['step0_ms']:.1f} "
          f"tokens_per_s={full['tokens_per_s']:.0f} peak_gb={full['peak_gb']:.2f} "
          f"flop_bound_ms={full['bound_ms']:.2f} ({full['flops']:.4g} FLOP at 989 TFLOP/s "
          f"bf16, data sheet) share={full['bound_share']:.3f} cli_s={full_s:.1f}", flush=True)
    prof = _train_profile(device)
    print(f"phase train: profile of one warm full-width step in this process: wall "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms (idle share "
          f"{prof['idle_share']:.3f}), {prof['launches']} device operations; by operator: "
          + "; ".join(f"{name} {ms:.1f} ms x{n}" for ms, n, name in prof["ops"])
          + "; by kernel: " + "; ".join(f"{name[:60]} {ms:.1f} ms x{n}"
                                        for ms, n, name in prof["kernels"]), flush=True)
    resume = _train_resume(work)
    shutil.rmtree(work, ignore_errors=True)
    out = {"reduced": worst, "full": full, "profile": prof, "resume": resume,
           "phase_s": time.perf_counter() - t_phase}
    print(f"phase train: ok resumed losses equal {resume['resumed']} "
          f"phase_s={out['phase_s']:.1f}", flush=True)
    return out


DIST_ARCH = TRAIN_ARCH
DIST_FULL = dict(steps=3, batch=8, seq=2_048, lr=3e-4)  # phase train's cell, cut to 3 steps
DIST_MESHES = ("2x2", "2x1")  # dp = 2 on both: the same MoE routing groups
DIST_ATTN = dict(batch=1, heads=8, kv=4, head_dim=256, length=131_072, shards=8)  # gemma3-4b global
DIST_ATTN_TOL = 2e-5  # tests/test_decode_attn.py
DIST_PIPE = dict(stages=4, micro=8, tokens=2_048, d_model=2_560, d_ff=10_240)  # gemma3-4b widths
DIST_PIPE_TOL = 1e-5  # tests/test_pipeline.py: rtol and atol
DIST_COMPRESSED = dict(loss=1e-4, param=5e-3, moved=1e-6)  # tests/test_compression.py


def _dist_mesh(spec: str, device):
    from repro_torch.launch.mesh import mesh_from_spec

    d, m = (int(p) for p in spec.split("x"))
    return mesh_from_spec(spec, devices=[device] * (d * m))


def _hold_step(what: str, got: dict, want: dict, opt_cfg, lr: float, step: int,
               dev) -> dict:
    """Two steps' results (``params``, ``m``, ``v``: full tensors by name,
    on any device) under the CPU tests' rule (tests/test_torch_train_rule.py):
    the moments by ``_moments_close`` (one bf16 ulp for m, two for v), the
    parameters within 1e-6 of what each side's own moments give. Compared
    leaf by leaf on ``dev``."""
    flips = _moments_close(got["m"], want["m"], f"{what}: m", 1, "dist", dev)
    flips += _moments_close(got["v"], want["v"], f"{what}: v", 2, "dist", dev)
    moved = 0
    worst = 0.0
    for name in want["params"]:
        g = {k: got[k][name].to(dev, torch.float32) for k in ("params", "m", "v")}
        w = {k: want[k][name].to(dev, torch.float32) for k in ("params", "m", "v")}
        d = g["params"].double() - w["params"].double()
        pred = -lr * (_adam_dir(g["m"], g["v"], step, opt_cfg)
                      - _adam_dir(w["m"], w["v"], step, opt_cfg))
        off = float((d - pred).abs().max())
        if off > 1e-6 or float(d.abs().max()) > 2 * opt_cfg.lr:
            fail(f"phase dist: {what}: param {name} differs by {off:.3g} from its moments' "
                 "update")
        worst = max(worst, off)
        moved += int((d.abs() > 1e-6).sum())
        del g, w, d, pred
    return {"flips": flips, "moved": moved, "param_err": worst}


def _replicas_identical(what: str, trees) -> int:
    """Every entry holding the same slice of a leaf holds the same bits."""
    n = 0
    for tree in trees:
        for name, s in tree.items():
            first = {}
            for c in s.coords():
                key = tuple((sl.start, sl.stop) for sl in s.slices(c))
                if key in first:
                    if not torch.equal(first[key], s.shards[c]):
                        fail(f"phase dist: {what}: replicated slice of {name} differs at {c}")
                    n += 1
                else:
                    first[key] = s.shards[c]
    return n


def _dist_reduced(device) -> dict:
    """The ten reduced architectures: one plan step on a 2x2 mesh of card
    entries against the same step on a 2x2 mesh of CPU entries (the rule),
    and a 1x1 card mesh against the single-device step, bit for bit."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed.elastic import gather, redistribute
    from repro_torch.distributed.sharding import make_plan
    from repro_torch.models.zoo import build
    from repro_torch.training import OptConfig, adamw_init, make_train_step
    from repro_torch.training.train import sharded_adamw_init

    opt_cfg = OptConfig(warmup_steps=1)
    out = {"flips": 0, "moved": 0, "param_err": 0.0, "replicas": 0}
    for name in sorted(ARCHS):
        cfg = reduced(ARCHS[name])
        model = build(cfg)
        net = model.init(torch.Generator().manual_seed(0))
        batch = _train_batch(cfg, TRAIN_B, TRAIN_S, seed=3)
        res = {}
        for label, dev, spec in (("card", device, "2x2"), ("cpu", torch.device("cpu"), "2x2"),
                                 ("one", device, "1x1")):
            plan = make_plan(_dist_mesh(spec, dev))
            params = redistribute(net, plan)
            opt = sharded_adamw_init(params, plan)
            step, _ = make_train_step(model, opt_cfg, plan)
            params, opt, met = step(params, opt, batch)
            if label == "card":
                out["replicas"] += _replicas_identical(f"reduced {name}",
                                                       (params, opt["m"], opt["v"]))
            res[label] = ({"params": gather(params), "m": gather(opt["m"]),
                           "v": gather(opt["v"])}, {k: float(v) for k, v in met.items()})
        (card, cm), (cpu, pm) = res["card"], res["cpu"]
        if abs(cm["loss"] - pm["loss"]) > 1e-5 or \
                abs(cm["grad_norm"] - pm["grad_norm"]) > 1e-5 * pm["grad_norm"]:
            fail(f"phase dist: reduced {name} 2x2: card {cm} against cpu {pm}")
        held = _hold_step(f"reduced {name} 2x2 card/cpu", card, cpu, opt_cfg, cm["lr"], 1,
                          device)
        for k in ("flips", "moved"):
            out[k] += held[k]
        out["param_err"] = max(out["param_err"], held["param_err"])
        # 1x1 on the card: the single-device step, bit for bit
        one_net = model.load({k: v.to(device, copy=True) for k, v in net.state_dict().items()})
        o, m = make_train_step(model, opt_cfg)(one_net, adamw_init(dict(one_net.named_parameters())),
                                               {k: v.to(device) for k, v in batch.items()})
        got, gm = res["one"]
        if any(gm[k] != float(m[k]) for k in ("loss", "grad_norm", "lr")):
            fail(f"phase dist: reduced {name} 1x1 {gm} != single-device {m}")
        for n, p in one_net.named_parameters():
            if not (torch.equal(got["params"][n], p.detach().cpu())
                    and torch.equal(got["m"][n], o["m"][n].cpu())
                    and torch.equal(got["v"][n], o["v"][n].cpu())):
                fail(f"phase dist: reduced {name} 1x1: {n} differs from the single-device step")
    return out


def _dist_full_run(device, spec: str, batches: list, profile: bool = False) -> dict:
    """DIST_FULL's steps of the plan step at full width on ``spec`` (cuda:0
    entries), from the seed's weights; the final state gathered to the host.
    With ``profile``, one more step (on the first batch) under
    ``torch.profiler``: wall time, device busy time, and the device time
    of the kernels launched under the step's ``plan_step.gather`` and
    ``plan_step.reduce`` ranges."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.elastic import gather, redistribute
    from repro_torch.distributed.sharding import make_plan
    from repro_torch.models.zoo import build
    from repro_torch.training import OptConfig, make_train_step
    from repro_torch.training.train import sharded_adamw_init

    model = build(ARCHS[DIST_ARCH])
    opt_cfg = OptConfig(lr=DIST_FULL["lr"], warmup_steps=1, total_steps=DIST_FULL["steps"])
    plan = make_plan(_dist_mesh(spec, device))
    net = model.init(torch.Generator(device).manual_seed(0), device)
    params = redistribute(net, plan)
    del net
    opt = sharded_adamw_init(params, plan)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    step, _ = make_train_step(model, opt_cfg, plan)
    rec = {"losses": [], "step_s": [], "lr": [], "grad_norm": []}
    for b in batches:
        _sync(device)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, b)
        rec["losses"].append(float(met["loss"]))
        rec["step_s"].append(time.perf_counter() - t0)
        rec["lr"].append(float(met["lr"]))
        rec["grad_norm"].append(float(met["grad_norm"]))
    rec["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    rec["replicas"] = _replicas_identical(f"full width {spec}", (params, opt["m"], opt["v"]))
    rec["state"] = {"params": gather(params), "m": gather(opt["m"]), "v": gather(opt["v"])}
    rec["opt_cfg"] = opt_cfg
    if profile:
        rec["profile"] = _dist_profile(device, lambda: step(params, opt, batches[0]))
    del params, opt
    torch.cuda.empty_cache()
    return rec


def _dist_profile(device, run) -> dict:
    """``run()`` (one plan step) under ``torch.profiler`` (CPU and CUDA
    activity): the window's wall time (ending in a sync), the device's busy
    time, and the device time of the kernels launched under each of the
    step's profiler ranges (``plan_step.gather``, ``plan_step.reduce``),
    with the number of times each range was entered."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, launches = 0.0, 0
    ranges = {"plan_step.gather": [0.0, 0], "plan_step.reduce": [0.0, 0]}
    for e in prof.events():
        if e.device_type.name == "CUDA" and e.name != "Command Buffer Full" \
                and e.name not in ranges:
            busy_ms += e.time_range.elapsed_us() / 1e3
            launches += 1
        elif e.device_type.name == "CPU" and e.name in ranges:
            ranges[e.name][0] += e.device_time_total / 1e3
            ranges[e.name][1] += 1
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "launches": launches, "gather_ms": ranges["plan_step.gather"][0],
            "gathers": ranges["plan_step.gather"][1],
            "reduce_ms": ranges["plan_step.reduce"][0],
            "reduces": ranges["plan_step.reduce"][1]}


def _dist_one_by_one(device, batch: dict) -> dict:
    """One plan step at full width on a 1x1 card mesh against phase
    train's single-device step from the same weights and batch: the loss,
    the gradient norm, and every parameter and moment, bit for bit; the
    plan step's time and peak (phase roofline holds them)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.zoo import build
    from repro_torch.training import OptConfig, adamw_init, make_train_step

    model = build(ARCHS[DIST_ARCH])
    opt_cfg = OptConfig(lr=DIST_FULL["lr"], warmup_steps=1, total_steps=DIST_FULL["steps"])
    net = model.init(torch.Generator(device).manual_seed(0), device)
    opt, met = make_train_step(model, opt_cfg)(net, adamw_init(dict(net.named_parameters())),
                                               batch)
    want = {"params": {n: p.detach().cpu() for n, p in net.named_parameters()},
            "m": {n: t.cpu() for n, t in opt["m"].items()},
            "v": {n: t.cpu() for n, t in opt["v"].items()}}
    loss, gnorm = float(met["loss"]), float(met["grad_norm"])
    del net, opt, met
    torch.cuda.empty_cache()
    one = _dist_full_run(device, "1x1", [batch])
    step_ms, peak_gb = one["step_s"][0] * 1e3, one["peak_gb"]
    if one["losses"][0] != loss or one["grad_norm"][0] != gnorm:
        fail(f"phase dist: full width 1x1: loss {one['losses'][0]} and norm "
             f"{one['grad_norm'][0]} != single-device {loss} and {gnorm}")
    n = 0
    for k in ("params", "m", "v"):
        for name, t in want[k].items():
            if not torch.equal(one["state"][k][name], t):
                fail(f"phase dist: full width 1x1: {k} {name} differs from the single-device "
                     "step")
            n += 1
    del one, want
    return {"loss": loss, "grad_norm": gnorm, "leaves_equal": n, "step_ms": step_ms,
            "peak_gb": peak_gb}


def _dist_full_width(device) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import synthetic_lm_batches

    cfg = ARCHS[DIST_ARCH]
    stream = synthetic_lm_batches(cfg.vocab, DIST_FULL["batch"], DIST_FULL["seq"], 0)
    batches = [{k: v.to(device) for k, v in next(stream).items()}
               for _ in range(DIST_FULL["steps"])]
    one = _dist_one_by_one(device, batches[0])
    runs = {spec: _dist_full_run(device, spec, batches, profile=spec == DIST_MESHES[0])
            for spec in DIST_MESHES}
    a, b = (runs[s] for s in DIST_MESHES)
    for spec, r in runs.items():
        if not all(np.isfinite(r["losses"])) or not r["losses"][-1] < r["losses"][0]:
            fail(f"phase dist: full width {spec}: the loss does not fall: {r['losses']}")
    if any(abs(x - y) > 1e-5 for x, y in zip(a["losses"], b["losses"])):
        fail(f"phase dist: full width losses {a['losses']} != {b['losses']}")
    held = _hold_step(f"full width {DIST_MESHES[0]} against {DIST_MESHES[1]}", a["state"],
                      b["state"], a["opt_cfg"], b["lr"][-1], DIST_FULL["steps"], device)
    # the same data rows: the model axis splits storage only, so the bits
    # should not move either (reported; the rule above is the check)
    held["leaves_differing"] = sum(
        not torch.equal(a["state"][k][n], b["state"][k][n])
        for k in ("params", "m", "v") for n in a["state"][k])
    flops, bound_ms = _train_flop_bound_ms(cfg, DIST_FULL["batch"], DIST_FULL["seq"])
    out = {"held": held, "flops": flops, "bound_ms": bound_ms, "one": one,
           "profile": a["profile"]}
    for spec, r in runs.items():
        warm = r["step_s"][1:]
        med = float(np.median(warm)) * 1e3
        out[spec] = {k: r[k] for k in ("losses", "step_s", "peak_gb", "replicas")}
        out[spec].update(step_ms_median=med,
                         tokens_per_s=DIST_FULL["batch"] * DIST_FULL["seq"] / (med / 1e3),
                         bound_share=bound_ms / med)
    del runs, a, b
    return out


def _row_steps(model, net, batch: dict, n_rows: int) -> dict:
    """The shared int8 step of each leaf in a compressed reduce over
    ``n_rows`` data rows: the largest |gradient| of any row's slice of
    ``batch`` (float32, no sharding context, as each row of
    ``make_compressed_dp_step`` computes it), over 127."""
    b = next(iter(batch.values())).shape[0]
    top: dict = {}
    for r in range(n_rows):
        net.zero_grad(set_to_none=True)
        mb = {k: v.reshape(n_rows, b // n_rows, *v.shape[1:])[r] for k, v in batch.items()}
        model.train_loss(net, mb).backward()
        for n, p in net.named_parameters():
            g = 0.0 if p.grad is None else float(p.grad.abs().max())
            top[n] = max(top.get(n, 0.0), g)
    net.zero_grad(set_to_none=True)
    return {n: t / 127.0 for n, t in top.items()}


def _reduce_error(got_m: dict, got_norm: float, want_m: dict, want_norm: float, steps: dict,
                  opt_cfg, dev) -> float:
    """A compressed step's reduced gradient against the exact step's, as a
    share of its bound (at most 1 passes), leaf by leaf on ``dev``. Both are
    read back from the first moments after one AdamW step from zero, m =
    (1 - b1) clip g, clip = min(1, clip_norm / grad_norm) from each step's
    own norm. Each data entry quantizes at its leaf's shared step s and
    errs by less than s, so their mean errs by less than s: each element
    is held within s (1 + 1e-3) + 1e-5 of the leaf's largest exact value,
    and the norms within the norm of those bounds."""
    clip_g = min(1.0, opt_cfg.clip_norm / max(got_norm, 1e-9))
    clip_w = min(1.0, opt_cfg.clip_norm / max(want_norm, 1e-9))
    worst = bound_sq = 0.0
    for n, m in want_m.items():
        w = m.to(dev).double() / ((1 - opt_cfg.b1) * clip_w)
        g = got_m[n].to(dev).double() / ((1 - opt_cfg.b1) * clip_g)
        tol = steps[n] * (1 + 1e-3) + 1e-5 * float(w.abs().max())
        worst = max(worst, float((g - w).abs().max()) / max(tol, 1e-30))
        bound_sq += w.numel() * tol ** 2
        del w, g
    return max(worst, abs(got_norm - want_norm) / max(bound_sq ** 0.5, 1e-30))


def _biased_psum(mesh, dp_axes):
    """The reference's compressed reduce (src/repro/training/compression.py:
    54-59), a control the reduce check must fail: each entry quantizes at
    its own scale and the int32 sum is dequantized at the max."""
    from repro_torch.training.compression import _quantize, _scale

    def fn(grads, generator):
        out = [{} for _ in grads]
        for name, g0 in grads[0].items():
            rnd = torch.rand(g0.shape, generator=generator, device=generator.device)
            scales = [_scale(g[name]) for g in grads]
            q32 = sum(_quantize(g[name], sc, rnd.to(g[name].device)).to(torch.int32)
                      .to(g0.device) for g, sc in zip(grads, scales))
            mean = q32.float() * torch.stack([sc.to(g0.device) for sc in scales]).max() \
                / len(grads)
            for o, g in zip(out, grads):
                o[name] = mean.to(g[name].device)
        return out

    return fn


def _unscaled_psum(mesh, dp_axes):
    """The port's reduce without the division by the entries (the sum, not
    the mean): a control the reduce check must fail."""
    from repro_torch.training.compression import compressed_psum

    reduce = compressed_psum(mesh, dp_axes)
    return lambda grads, gen: [{n: t * len(grads) for n, t in o.items()}
                               for o in reduce(grads, gen)]


def _dist_compressed(device) -> dict:
    """One compressed step on 2x1 at full width against the exact plan step
    with cast_bf16=False on the same mesh, weights and batch (both route
    two groups): the reference test's bounds, then the reduced gradient
    within each leaf's int8 step of the exact one; the same check must
    fail with the reference's biased reduce and with the undivided sum."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.elastic import gather, place, redistribute
    from repro_torch.distributed.sharding import make_plan
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models.zoo import build
    from repro_torch.training import OptConfig, make_train_step
    from repro_torch.training import train as train_mod
    from repro_torch.training.train import make_compressed_dp_step, sharded_adamw_init

    cfg = ARCHS[DIST_ARCH]
    model = build(cfg)
    opt_cfg = OptConfig(lr=DIST_FULL["lr"], warmup_steps=1, total_steps=DIST_FULL["steps"])
    batch = {k: v.to(device) for k, v in next(synthetic_lm_batches(
        cfg.vocab, DIST_FULL["batch"], DIST_FULL["seq"], 0)).items()}
    mesh = _dist_mesh("2x1", device)
    start = model.init(torch.Generator(device).manual_seed(0), device)
    plan = make_plan(mesh)
    params = redistribute(start, plan)
    step, _ = make_train_step(model, opt_cfg, plan, cast_bf16=False)
    params, opt, exact_met = step(params, sharded_adamw_init(params, plan), batch)
    exact, exact_m = gather(params), gather(opt["m"])  # on the host
    exact_norm = float(exact_met["grad_norm"])
    del params, opt
    torch.cuda.empty_cache()
    steps = _row_steps(model, start, batch, 2)
    names = [n for n, _ in start.named_parameters()]
    out = {}
    for label, control in (("port", None), ("biased", _biased_psum),
                           ("unscaled", _unscaled_psum)):
        rep = {n: place(p.detach(), mesh, ()) for n, p in start.named_parameters()}
        opt = {"m": {n: s.map(torch.zeros_like) for n, s in rep.items()},
               "v": {n: s.map(torch.zeros_like) for n, s in rep.items()},
               "step": place(torch.zeros((), dtype=torch.int32), mesh, ())}
        real = train_mod.compressed_psum
        if control is not None:
            train_mod.compressed_psum = control
        try:
            comp = make_compressed_dp_step(model, opt_cfg, mesh, ("data",))
        finally:
            train_mod.compressed_psum = real
        _sync(device)
        t0 = time.perf_counter()
        rep, opt, met = comp(rep, opt, batch, torch.Generator(device).manual_seed(42))
        loss = float(met["loss"])
        step_s = time.perf_counter() - t0
        err = _reduce_error({n: s.shards[0, 0] for n, s in opt["m"].items()},
                            float(met["grad_norm"]), exact_m, exact_norm, steps, opt_cfg, device)
        if control is not None:
            if not err > 1.0:
                fail(f"phase dist: compressed step: the {label} control passed the reduce "
                     f"check ({err:.3g} of its bound)")
            out[f"{label}_reduce_err"] = err
            del rep, opt
            torch.cuda.empty_cache()
            continue
        if err > 1.0:
            fail(f"phase dist: compressed step: the reduced gradient is {err:.3g} of its "
                 "bound from the exact step's")
        d_loss = abs(loss - float(exact_met["loss"]))
        d_param = max(float((rep[n].shards[0, 0] - exact[n].to(device)).abs().max())
                      for n in names)
        moved = max(float((rep[n].shards[0, 0] - p.detach()).abs().max())
                    for n, p in start.named_parameters())
        if d_loss >= DIST_COMPRESSED["loss"] or d_param >= DIST_COMPRESSED["param"] \
                or moved <= DIST_COMPRESSED["moved"]:
            fail(f"phase dist: compressed step: loss diff {d_loss:.3g}, param diff "
                 f"{d_param:.3g}, moved {moved:.3g} (bounds {DIST_COMPRESSED})")
        if any(not torch.equal(s.shards[0, 0], s.shards[1, 0]) for s in rep.values()):
            fail("phase dist: compressed step: the two replicas differ")
        out.update(loss_err=d_loss, param_err=d_param, moved=moved, step_s=step_s, loss=loss,
                   reduce_err=err)
        del rep, opt
        torch.cuda.empty_cache()
    del exact, exact_m, start
    torch.cuda.empty_cache()
    return out


def _dist_decode_attention(device) -> dict:
    """Sequence-sharded decode attention over a (data,) mesh of cuda:0
    entries against decode_attention on the whole cache, at gemma3-4b's
    global-layer shapes and a 131,072-position float32 cache."""
    from repro_torch.distributed.elastic import place
    from repro_torch.launch.mesh import mesh_from_shape
    from repro_torch.models.layers.attention import decode_attention
    from repro_torch.serving.decode_attn import seq_sharded_decode_attention

    a = DIST_ATTN
    g = torch.Generator(device).manual_seed(11)
    L = a["length"]
    q = torch.randn((a["batch"], 1, a["heads"], a["head_dim"]), generator=g, device=device)
    k = torch.randn((a["batch"], L, a["kv"], a["head_dim"]), generator=g, device=device)
    v = torch.randn((a["batch"], L, a["kv"], a["head_dim"]), generator=g, device=device)
    lengths = torch.randint(L // 2, L + 1, (a["batch"],), generator=g, device=device)
    mesh = mesh_from_shape((a["shards"],), ("data",), [device] * a["shards"])
    spec = (None, "data", None, None)
    ks, vs = place(k, mesh, spec), place(v, mesh, spec)
    out = {}
    for window in (0, 1_024):
        fn = seq_sharded_decode_attention(mesh, seq_axis="data", window=window)
        got = fn(q, ks, vs, lengths)
        want = decode_attention(q, k, v, lengths, window=window)
        err = float(((got - want).abs() - DIST_ATTN_TOL * want.abs()).max())
        if not err <= DIST_ATTN_TOL:
            fail(f"phase dist: decode attention window={window}: beyond {DIST_ATTN_TOL}")
        out[window] = {"max_abs_err": float((got - want).abs().max()),
                       "sharded_ms": time_ms(lambda: fn(q, ks, vs, lengths), 10),
                       "whole_ms": time_ms(lambda: decode_attention(q, k, v, lengths,
                                                                    window=window), 10)}
    del q, k, v, ks, vs
    torch.cuda.empty_cache()
    return out


def _dist_pipeline(device) -> dict:
    """A 4-stage GPipe pipeline of RMS norm + GeGLU MLP stages at gemma3-4b's
    widths over (stage,) cuda:0 entries against the sequential stack."""
    from types import SimpleNamespace

    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_forward
    from repro_torch.launch.mesh import mesh_from_shape
    from repro_torch.models.layers.common import rms_norm
    from repro_torch.models.layers.mlp import apply_mlp

    p = DIST_PIPE
    S, d, f = p["stages"], p["d_model"], p["d_ff"]
    g = torch.Generator(device).manual_seed(12)
    params = {"norm": torch.randn((S, d), generator=g, device=device) * 0.1,
              "w_gate": torch.randn((S, d, f), generator=g, device=device) * d ** -0.5,
              "w_up": torch.randn((S, d, f), generator=g, device=device) * d ** -0.5,
              "w_down": torch.randn((S, f, d), generator=g, device=device) * f ** -0.5}
    x = torch.randn((p["micro"] * p["tokens"], d), generator=g, device=device)

    def stage(ps, xb):
        w = SimpleNamespace(w_gate=ps["w_gate"], w_up=ps["w_up"], w_down=ps["w_down"])
        return xb + apply_mlp(w, rms_norm(xb, ps["norm"]), "geglu")

    def sequential():
        h = x
        for s in range(S):
            h = stage({k: v[s] for k, v in params.items()}, h)
        return h

    mesh = mesh_from_shape((S,), ("stage",), [device] * S)
    fwd = pipeline_forward(mesh, stage, n_micro=p["micro"])
    y, ref = fwd(params, x), sequential()
    bad = ((y - ref).abs() > DIST_PIPE_TOL + DIST_PIPE_TOL * ref.abs()).sum()
    if int(bad):
        fail(f"phase dist: pipeline: {int(bad)} entries beyond rtol=atol={DIST_PIPE_TOL} "
             f"(max {float((y - ref).abs().max()):.3g})")
    out = {"max_abs_err": float((y - ref).abs().max()),
           "pipeline_ms": time_ms(lambda: fwd(params, x), 3, warmup=1),
           "sequential_ms": time_ms(sequential, 3, warmup=1),
           "bubble": bubble_fraction(S, p["micro"])}
    del params, x, y, ref
    torch.cuda.empty_cache()
    return out


def _dist_cli(work: Path) -> dict:
    """``launch/train.py --mesh host --device cuda:0`` (4x2 of cuda:0) at
    reduced glm4-9b: 4 steps with checkpoints at 2 and 4, then the step-2
    checkpoint resumed; losses and the step-4 checkpoint bit for bit."""
    from repro_torch.distributed.checkpoint import CheckpointManager

    base = ["--arch", TRAIN_RESUME_ARCH, "--reduced", "--mesh", "host", "--device", "cuda:0",
            "--steps", "4", "--ckpt-every", "2", "--batch", "8", "--seq", "32", "--log-every", "1"]
    full = _train_cli([*base, "--ckpt-dir", str(work / "full")], work / "a.json")
    shutil.copytree(work / "full", work / "part")
    shutil.rmtree(work / "part" / "ckpt_0000000004")
    resumed = _train_cli([*base, "--ckpt-dir", str(work / "part"), "--resume"], work / "b.json")
    if full["mesh"] != {"shape": {"data": 4, "model": 2}, "n_devices": 8} or \
            not full["device"].startswith("cuda"):
        fail(f"phase dist: --mesh host ran on {full['device']} over {full['mesh']}")
    if resumed["start_step"] != 2 or resumed["losses"] != full["losses"][2:]:
        fail(f"phase dist: resumed {resumed['losses']} != {full['losses'][2:]}")
    a, _ = CheckpointManager(str(work / "full")).restore(4)
    b, _ = CheckpointManager(str(work / "part")).restore(4)
    for key in ("params", "opt"):
        for x, y in zip(_flat_leaves(a[key]), _flat_leaves(b[key])):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                fail(f"phase dist: the resumed step-4 checkpoint differs in {key}")
    return {"losses": full["losses"], "resumed": resumed["losses"],
            "tokens_per_s": full["tokens_per_s"]}


def _flat_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_leaves(tree[k])]
    return [tree]


def phase_dist(device) -> dict:
    """The LM scaffold over a mesh (no kernel of rows 1-11): plan steps of
    the reduced architectures, card against CPU; granite-moe-1b-a400m at
    full width on 2x2 and 2x1; a compressed step; sequence-sharded decode
    attention; the pipeline; and the --mesh host CLI resumed."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    red = _dist_reduced(device)
    print(f"phase dist: reduced ok archs=10 one plan step on 2x2 cuda:0 == on 2x2 cpu (the "
          f"rule: moment entries at one bf16 ulp {red['flips']}, param entries apart by more "
          f"than 1e-6 {red['moved']}, param_err={red['param_err']:.3g}), replicated slices "
          f"identical {red['replicas']}, 1x1 == single-device bit for bit "
          f"s={time.perf_counter() - t_phase:.1f}", flush=True)
    t0 = time.perf_counter()
    full = _dist_full_width(device)
    for spec in DIST_MESHES:
        r = full[spec]
        print(f"phase dist: full-width {DIST_ARCH} on {spec} of cuda:0 "
              f"B={DIST_FULL['batch']} S={DIST_FULL['seq']} lr={DIST_FULL['lr']} "
              f"losses={r['losses']} step_ms={[round(s * 1e3, 1) for s in r['step_s']]} "
              f"median(after step 0)={r['step_ms_median']:.1f} "
              f"tokens_per_s={r['tokens_per_s']:.0f} flop_bound_ms={full['bound_ms']:.2f} "
              f"share={r['bound_share']:.4f} peak_gb={r['peak_gb']:.2f} "
              f"replicated slices identical {r['replicas']}", flush=True)
    pr, one = full["profile"], full["one"]
    print(f"phase dist: full width 1x1 == single-device step bit for bit (loss {one['loss']}, "
          f"grad_norm {one['grad_norm']}, {one['leaves_equal']} leaves); one more "
          f"{DIST_MESHES[0]} step under torch.profiler: wall_ms={pr['wall_ms']:.1f} "
          f"device_busy_ms={pr['busy_ms']:.1f} idle_share={pr['idle_share']:.4f} "
          f"device_ops={pr['launches']} gather_device_ms={pr['gather_ms']:.1f} "
          f"({pr['gathers']} ranges) reduce_device_ms={pr['reduce_ms']:.1f} "
          f"({pr['reduces']} ranges)", flush=True)
    h = full["held"]
    print(f"phase dist: full width {DIST_MESHES[0]} == {DIST_MESHES[1]} under the rule after "
          f"{DIST_FULL['steps']} steps (moment entries at one bf16 ulp {h['flips']}, param "
          f"entries apart by more than 1e-6 {h['moved']}, param_err={h['param_err']:.3g}, "
          f"leaves not bit-identical {h['leaves_differing']}) "
          f"s={time.perf_counter() - t0:.1f}", flush=True)
    comp = _dist_compressed(device)
    print(f"phase dist: compressed step on 2x1 (int8, shared scale) against the exact plan "
          f"step (cast_bf16=False): loss_err={comp['loss_err']:.3g} (< 1e-4) "
          f"param_err={comp['param_err']:.3g} (< 5e-3) moved={comp['moved']:.3g} (> 1e-6) "
          f"reduced gradient {comp['reduce_err']:.3g} of its int8 bound (<= 1; controls: "
          f"the reference's biased reduce {comp['biased_reduce_err']:.3g}, the undivided sum "
          f"{comp['unscaled_reduce_err']:.3g}, both > 1) "
          f"step_ms={comp['step_s'] * 1e3:.1f}", flush=True)
    attn = _dist_decode_attention(device)
    a = DIST_ATTN
    print(f"phase dist: sequence-sharded decode attention B={a['batch']} H={a['heads']} "
          f"KV={a['kv']} hd={a['head_dim']} L={a['length']} f32 over {a['shards']} cuda:0 "
          f"entries == decode_attention (tol {DIST_ATTN_TOL}): " + "; ".join(
              f"window={w} max_abs_err={r['max_abs_err']:.3g} sharded_ms={r['sharded_ms']:.3f} "
              f"whole_ms={r['whole_ms']:.3f}" for w, r in attn.items()), flush=True)
    pipe = _dist_pipeline(device)
    p = DIST_PIPE
    print(f"phase dist: pipeline {p['stages']} stages x (RMS norm + GeGLU {p['d_model']}->"
          f"{p['d_ff']}) over {p['micro']} micro-batches of {p['tokens']} tokens == sequential "
          f"(rtol=atol={DIST_PIPE_TOL}) max_abs_err={pipe['max_abs_err']:.3g} "
          f"pipeline_ms={pipe['pipeline_ms']:.2f} sequential_ms={pipe['sequential_ms']:.2f} "
          f"bubble_fraction={pipe['bubble']:.4f}", flush=True)
    work = ROOT / "build" / "smoke_dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cli = _dist_cli(work)
    shutil.rmtree(work, ignore_errors=True)
    out = {"reduced": red, "full": full, "compressed": comp, "attn": attn, "pipe": pipe,
           "cli": cli, "phase_s": time.perf_counter() - t_phase}
    print(f"phase dist: ok --mesh host (4x2 of cuda:0) resumed from step 2 equals the "
          f"uninterrupted run {cli['resumed']} phase_s={out['phase_s']:.1f}", flush=True)
    return out


# a plan step's peak estimate over its measured peak. The estimate counts
# every gradient of the row at once beside the step's peak activations; the
# step holds only those its backward has reached (for phase dist's cell up
# to 5.3 GB of about 40), so it may lie above by that much, not below. A
# term missed or counted twice (the moments 10.7 GB, a gathered copy or the
# gradients 5.3 GB) leaves the band
ROOFLINE_PEAK_BAND = (0.9, 1.25)


def _one_card(rec: dict) -> tuple[float, float, float]:
    """``(step_s, argument_bytes, peak_estimate_bytes)`` of a train record
    whose mesh entries all sit on one card. The card runs every computing
    entry's work in turn: the step takes at least the larger of their flops
    at the card's peak and every entry's bytes at its memory rate (each
    computing entry moves ``ROW_TERMS``, dev0 also its own terms, every
    entry the optimizer's; the copies between entries stay in the card's
    memory and are among those bytes). The card holds every entry's
    arguments, one row's step at a time, and the rows' gradients summed so
    far while a later row runs."""
    from repro_torch.launch.dryrun import ROW_TERMS

    rl, mem = rec["roofline"], rec["memory"]
    rows, entries, d = rec["compute_entries"], rec["entries"], rl["bytes_detail"]
    nbytes = (sum(d.values()) + (rows - 1) * sum(d[k] for k in ROW_TERMS)
              + (entries - 1) * d["optimizer"])
    step = max(rows * rl["t_compute"], nbytes / H100.hbm_bw)
    argument = mem["argument_bytes"] * entries
    held = mem["detail"]["row_gradients"] if rows > 1 else 0
    peak = argument + sum(v for k, v in mem["detail"].items() if k != "argument") + held
    return step, argument, peak


def phase_roofline(device, timing: dict, tiled: dict, lm: dict, dist: dict) -> dict:
    """``launch.dryrun``'s arithmetic at the cells this smoke measured (no
    kernel of rows 1-11; nothing runs on the card): each measured step must
    take at least its roofline step time, each measured peak at least the
    bytes the step holds before it starts, and each plan step's peak
    estimate must lie within ROOFLINE_PEAK_BAND of its measured peak."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import lower_cell, lower_mining, mining_terms, tiled_terms
    from repro_torch.launch.mesh import mesh_from_shape

    t_phase = time.perf_counter()
    one = mesh_from_shape((1, 1), ("data", "model"), [device])
    two = mesh_from_shape((2, 2), ("data", "model"), [device] * 4)
    plan_shape = ShapeConfig("smoke_dist", DIST_FULL["seq"], DIST_FULL["batch"], "train")
    d11, d22, serve = dist["full"]["one"], dist["full"]["2x2"], LM_SERVE
    cases = [
        ("plan 1x1", DIST_ARCH, plan_shape, one, {"plan_step": d11["step_ms"]},
         {"plan_step": d11["peak_gb"] * 1e9}),
        ("plan 2x2", DIST_ARCH, plan_shape, two, {"plan_step": d22["step_ms_median"]},
         {"plan_step": d22["peak_gb"] * 1e9}),
        ("prefill", LM_ARCH, ShapeConfig("smoke_prefill", serve["prompt_len"], serve["batch"],
                                         "prefill"), one,
         {k: lm[k]["prefill_s"] * 1e3 for k in ("cli", "inproc")},
         {k: lm[k]["peak_gb"] * 1e9 for k in ("cli", "inproc")}),
        ("decode", LM_ARCH, ShapeConfig("smoke_decode", serve["prompt_len"] + serve["max_new"],
                                        serve["batch"], "decode"), one,
         {k: lm[k]["step_ms_median"] for k in ("cli", "inproc")},
         {k: lm[k]["peak_gb"] * 1e9 for k in ("cli", "inproc")}),
    ]
    out = {"cells": {}}
    for label, arch, shape, mesh, steps, peaks in cases:
        rec = lower_cell(arch, shape, mesh=mesh)
        rl, mem = rec["roofline"], rec["memory"]
        plan = shape.kind == "train"
        if plan:
            step_s, arg, est = _one_card(rec)
        else:
            step_s, arg, est = rl["step_time"], mem["argument_bytes"], mem["peak_estimate_bytes"]
        bound_ms = step_s * 1e3
        cell = {"bound_ms": bound_ms, "t_compute_ms": rl["t_compute"] * 1e3,
                "t_memory_ms": rl["t_memory"] * 1e3, "t_collective_ms": rl["t_collective"] * 1e3,
                "argument_gb": arg / 1e9, "peak_estimate_gb": est / 1e9, "steps_ms": steps,
                "peaks_gb": {k: v / 1e9 for k, v in peaks.items()},
                "step_over_bound": {k: v / bound_ms for k, v in steps.items()},
                "estimate_over_peak": {k: est / v for k, v in peaks.items()}}
        out["cells"][label] = cell
        shared = mesh.devices.size > 1
        print(f"phase roofline: {label} {arch} B={shape.global_batch} S={shape.seq_len} on "
              f"{rec['mesh']} of {device}"
              f"{' (its entries share the card: summed over them)' if shared else ''}: "
              f"step_time {bound_ms:.3f} ms (dev0's compute {cell['t_compute_ms']:.3f}, memory "
              f"{cell['t_memory_ms']:.3f}, collective {cell['t_collective_ms']:.3f}) beside "
              f"measured {', '.join(f'{k} {v:.3f} ms' for k, v in steps.items())} "
              f"(x{', x'.join(f'{v:.1f}' for v in cell['step_over_bound'].values())}); "
              f"peak_estimate {est / 1e9:.2f} GB beside measured "
              f"{', '.join(f'{k} {v / 1e9:.2f} GB' for k, v in peaks.items())} (ratio "
              f"{', '.join(f'{v:.3f}' for v in cell['estimate_over_peak'].values())}"
              f"{f' within {ROOFLINE_PEAK_BAND}' if plan else ''}); argument {arg / 1e9:.2f} GB; "
              f"dev0's detail " + json.dumps({k: round(v / 1e9, 3)
                                              for k, v in mem["detail"].items()}), flush=True)
        for k, v in steps.items():
            if v < bound_ms:
                fail(f"phase roofline: {label} {k} step {v:.3f} ms is faster than its roofline "
                     f"step time {bound_ms:.3f} ms: a count is wrong")
        for k, v in peaks.items():
            if v < arg:
                fail(f"phase roofline: {label} {k} peak {v / 1e9:.2f} GB is below the bytes the "
                     f"step holds before it starts, {arg / 1e9:.2f} GB: a count is wrong")
        for k, r in cell["estimate_over_peak"].items():
            if plan and not ROOFLINE_PEAK_BAND[0] <= r <= ROOFLINE_PEAK_BAND[1]:
                fail(f"phase roofline: {label} {k} peak estimate {est / 1e9:.2f} GB is {r:.3f} "
                     f"of the measured peak, outside {ROOFLINE_PEAK_BAND}: a count is wrong")

    r4 = timing["intersect_count_indexed"]
    count = mining_terms(r4["t"], r4["W"], r4["M"], 1, 1, write=False)["roofline"]
    at11 = tiled_terms(tiled["T"], TILED_BM, tiled["frontier"]["W"])
    prod = lower_mining(False)[0]
    out["mining"] = {"count_t_memory_ms": count["t_memory"] * 1e3, "row4_kernel_ms": r4["ms"],
                     "row4_bound_ms": r4["bound_ms"], "tiled_row11": at11,
                     "tiled_production": prod["roofline"]}
    print(f"phase roofline: mining count row at row 4's shape (t={r4['t']}, W={r4['W']}, "
          f"M={r4['M']}, one entry): t_memory {count['t_memory'] * 1e3:.4f} ms, t_compute "
          f"{count['t_compute'] * 1e3:.4f} ms beside row 4's kernel_ms {r4['ms']:.4f} and "
          f"bound_ms {r4['bound_ms']:.4f}; the tiled entry priced on the H100 at row 11's "
          f"shape (T={tiled['T']}, bm={TILED_BM}, W={tiled['frontier']['W']}): t_memory "
          f"{at11['t_memory'] * 1e3:.4f} ms (both blocks of every tile fetched) t_compute "
          f"{at11['t_compute'] * 1e3:.4f} ms beside row 11's kernel_ms {tiled['kernel_ms']:.4f} "
          f"and bound_ms {tiled['bound_ms']:.4f}; at the dry run's shape ({prod['shape']}, "
          f"pod16x16) t_memory {prod['roofline']['t_memory'] * 1e3:.4f} ms t_compute "
          f"{prod['roofline']['t_compute'] * 1e3:.4f} ms", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase roofline: ok phase_s={out['phase_s']:.1f}", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        sys.exit(2)
    import repro_torch  # noqa: F401  (the port must be in this checkout)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    rates = phase_device()
    n_words = (1_000_000 + 31) // 32  # the Poker-hand table's bitset width
    batch_cap = max(4096, (1 << 28) // n_words)  # core.frontier.mine_levels' batch cap
    from repro_torch.kernels.intersect import next_bucket

    timing = phase_kernels(device, n_words, next_bucket(batch_cap), rates)
    itemize_rows = phase_itemize(device)
    crc_row = phase_crc32(device)
    launches, *poker = phase_main(device)
    main_wall_s = poker[1].wall_time
    connect_launches, *connect = phase_host_classified(device)
    launches.update({k: v for k, v in connect_launches.items()
                     if k in ("intersect_write_indexed", "intersect_count_indexed")})
    launches.update(phase_gathered(device, poker, connect))
    poker_prep, poker_res = poker
    del poker, connect
    phase_checkpoint(device)
    cov_launches, table_bits, qi3, poker_profile = phase_privacy(device, poker_res)
    launches.update(cov_launches)
    torch.cuda.empty_cache()
    service = phase_service(device, poker_res)
    crc_launches = phase_durability(device, poker_res, service)
    # the multi-device and multi-process paths: their launches add to the
    # main path's (rows 1-4 and both coverage kernels)
    for name, n in phase_mesh(device, poker_prep, poker_res, main_wall_s, poker_profile,
                              service).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in phase_fleet(device, service).items():
        launches[name] = launches.get(name, 0) + n
    shutil.rmtree(service["tmp"], ignore_errors=True)
    del service, poker_profile
    cov = phase_coverage_kernel(device, table_bits, qi3, rates, poker_res)
    del table_bits, qi3, poker_res
    tiled = phase_tiled(device, poker_prep, rates)
    del poker_prep
    lm = phase_lm(device)
    phase_train(device)
    dist = phase_dist(device)
    phase_roofline(device, timing, tiled, lm, dist)

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
        **{f"poker_k{b['K']}_{key}": b[src] for b in cov["poker"] if b["kernel"] == COVERAGE
           for key, src in (("ms", "graph_ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"))},
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
    # the three itemize kernels as one entry: their time together at the
    # Poker-hand cell's shape, and at the Connect-4 cell's beside it; the
    # launches are the main path's prepare
    ph, c4 = itemize_rows["poker-hand.cold-mine"], itemize_rows["connect-4.cold-mine"]
    kernels.append({
        "name": "itemize", "kernels": list(ITEMIZE), "route": "cuda", "source": ITEMIZE_SOURCE,
        "replaces": ITEMIZE_REPLACES, "launches": {k: launches[k] for k in ITEMIZE},
        "max_abs_err": 0, "ms": ph["kernel_ms"], "kernel_ms": ph["kernel_ms"],
        "plain_ms": ph["plain_ms"], "bound_ms": ph["bound_ms"], "bound_by": ph["bound_by"],
        "library_ms": None, "upload_ms": ph["upload_ms"], "itemize_ms": ph["itemize_ms"],
        **{f"connect4_{k}": c4[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "upload_ms",
                                            "itemize_ms")},
    })
    # the CRC-32 kernels as one entry: their time together over level 3's
    # array, contiguous and padded; the launches are the durable server's
    # cold mine's (phase durability)
    kernels.append({
        "name": "crc32", "kernels": ["crc32_blocks_kernel", "crc32_finish_kernel"],
        "route": "cuda", "source": CRC32_SOURCE, "replaces": CRC32_REPLACES,
        "launches": crc_launches, "max_abs_err": 0, "ms": crc_row["kernel_ms"],
        "kernel_ms": crc_row["kernel_ms"], "plain_ms": crc_row["plain_ms"],
        "bound_ms": crc_row["bound_ms"], "bound_by": crc_row["bound_by"], "library_ms": None,
        "padded_ms": crc_row["padded_ms"], "bytes": crc_row["bytes"],
    })
    print(f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
