"""Mining CLI: dataset -> Kyiv -> minimal τ-infrequent itemsets, with
optional mesh sharding and level checkpointing.

  python -m repro_torch.launch.mine --dataset poker --n 100000 --tau 1 --kmax 4
  python -m repro_torch.launch.mine --engine torch --device cpu --n 2000
  python -m repro_torch.launch.mine --fimi path/to/connect.dat ...
  python -m repro_torch.launch.mine --ckpt-dir /path/to/ckpts ...
  python -m repro_torch.launch.mine --sharded ...                  # the visible cards
  python -m repro_torch.launch.mine --sharded --mesh 2x2 --device cuda:0

Runs the CUDA kernels on the card by default (``--engine cuda``); with no
card that raises, and ``--device cpu`` or ``--engine numpy`` mines on the
CPU. ``--ckpt-dir`` saves every level boundary (``ckpt_<level>``: the stored
level's ``itemsets``, ``counts`` and host ``bits``, and ``next_k``, with meta
``tau`` and ``kmax``) in the reference package's checkpoint format.

``--sharded`` mines through a word-sharded mesh (``core.sharded``): pairs
over ``data``, words over ``model``. Its shape is ``--mesh`` (``DATAxMODEL``),
or by default up to ``4x2`` shrunk to the visible cards. A ``--device`` with
an index (``cuda:0``), or ``cpu``, names one device that every mesh entry
repeats; ``cuda`` spreads the entries over the visible cards.
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
    ap.add_argument("--sharded", action="store_true",
                    help="shard over a mesh of devices (pairs x words)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="the --sharded mesh's shape (default: up to 4x2 over the visible cards)")
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

    pipeline_factory = None
    if args.sharded or args.mesh:
        pipeline_factory = _sharded_factory(args, cfg)
        mesh = pipeline_factory.placement.mesh
        print(f"sharded over mesh {mesh.shape} "
              f"({len(mesh.distinct_devices)} distinct device(s))")

    hook = None
    if args.ckpt_dir:
        cm = CheckpointManager(args.ckpt_dir)

        def hook(k, state):
            lvl = state["level"]
            cm.save(k, {"itemsets": lvl.itemsets, "counts": lvl.counts,
                        "bits": lvl.bits, "next_k": state["next_k"]},
                    {"tau": cfg.tau, "kmax": cfg.kmax})

    res = mine_preprocessed(prep, cfg, pipeline_factory=pipeline_factory, on_level_end=hook)

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


def _sharded_factory(args, cfg):
    from ..core.sharded import make_sharded_pipeline
    from .mesh import mesh_for_device

    if cfg.engine == "numpy":
        raise SystemExit("--sharded needs --engine torch or cuda")
    return make_sharded_pipeline(mesh_for_device(args.mesh, args.device),
                                 word_axis="model", fused_classify=cfg.fused_classify,
                                 engine=cfg.engine, indexed=cfg.indexed_kernel)


if __name__ == "__main__":
    main()
