"""Mining CLI: dataset -> Kyiv -> minimal τ-infrequent itemsets, with
optional level checkpointing.

  python -m repro_torch.launch.mine --dataset poker --n 100000 --tau 1 --kmax 4
  python -m repro_torch.launch.mine --engine torch --device cpu --n 2000
  python -m repro_torch.launch.mine --fimi path/to/connect.dat ...
  python -m repro_torch.launch.mine --ckpt-dir /path/to/ckpts ...

Runs the CUDA kernels on the card by default (``--engine cuda``); with no
card that raises, and ``--device cpu`` or ``--engine numpy`` mines on the
CPU. ``--ckpt-dir`` saves every level boundary (``ckpt_<level>``: the stored
level's ``itemsets``, ``counts`` and host ``bits``, and ``next_k``, with meta
``tau`` and ``kmax``) in the reference package's checkpoint format.
"""

from __future__ import annotations

import argparse
import json

from ..core import KyivConfig, itemize, preprocess
from ..core.kyiv import mine_preprocessed
from ..data.loaders import read_fimi
from ..data.synth import DATASETS
from ..distributed.checkpoint import CheckpointManager


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="randomized", choices=sorted(DATASETS))
    ap.add_argument("--fimi", default=None, help="path to a FIMI-format file")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--kmax", type=int, default=3)
    ap.add_argument("--ordering", default="ascending")
    ap.add_argument("--no-bounds", action="store_true")
    ap.add_argument("--engine", default="cuda", choices=["numpy", "torch", "cuda"])
    ap.add_argument("--device", default="cuda", help="torch device of the torch/cuda engines")
    ap.add_argument("--no-fused-classify", action="store_true",
                    help="classify on the host (the unfused baseline path)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write results JSON here")
    args = ap.parse_args(argv)

    if args.fimi:
        D = read_fimi(args.fimi)
    else:
        gen = DATASETS[args.dataset]
        if args.dataset == "randomized":
            D = gen(args.n, args.m, seed=args.seed)
        else:
            D = gen(n=args.n, seed=args.seed)

    cfg = KyivConfig(tau=args.tau, kmax=args.kmax, ordering=args.ordering,
                     use_bounds=not args.no_bounds, engine=args.engine, device=args.device,
                     fused_classify=not args.no_fused_classify)
    prep = preprocess(itemize(D), cfg.tau, ordering=cfg.ordering, seed=cfg.seed)

    hook = None
    if args.ckpt_dir:
        cm = CheckpointManager(args.ckpt_dir)

        def hook(k, state):
            lvl = state["level"]
            cm.save(k, {"itemsets": lvl.itemsets, "counts": lvl.counts,
                        "bits": lvl.bits, "next_k": state["next_k"]},
                    {"tau": cfg.tau, "kmax": cfg.kmax})

    res = mine_preprocessed(prep, cfg, on_level_end=hook)

    print(f"dataset {D.shape}, |L| = {prep.n_l}, tau={cfg.tau}, kmax={cfg.kmax}, "
          f"engine={cfg.engine}, device={cfg.device}")
    print(f"minimal tau-infrequent itemsets: {len(res.itemsets)}")
    for s in res.stats:
        print(f"  k={s.k}: candidates={s.candidates} B={s.type_b} "
              f"intersections={s.intersections} emitted={s.emitted} "
              f"stored={s.stored} t={s.time_total:.3f}s")
    print(f"wall time {res.wall_time:.3f}s "
          f"(intersect {res.total_intersect_time:.3f}s = "
          f"{res.total_intersect_time / max(res.wall_time, 1e-9):.0%})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {"itemsets": [{"items": list(ids), "count": c} for ids, c in res.itemsets],
                 "stats": [vars(s) for s in res.stats]},
                f, indent=1, default=str)


if __name__ == "__main__":
    main()
