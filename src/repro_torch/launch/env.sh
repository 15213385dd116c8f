# Fleet launch environment for serve_miner (source before launching).
#
# tcmalloc for the host-side bitset churn of the append/itemize path, and no
# large-allocation reports on multi-GB bitset matrices.
# `repro_torch.launch.mesh.launch_env_summary` records the resulting
# environment beside every multi-process number.
#
# No XLA flags: no XLA runs in this package. No NCCL variables either: the
# mesh sums its partial popcounts with device copies inside one process, and
# the fleet sums them through the TCPStore collective (core/collective.py),
# so nothing here calls NCCL.
#
# Usage:
#   source src/repro_torch/launch/env.sh
#   python -m repro_torch.launch.serve_miner --num-processes 2 --process-id $ID \
#     --coordinator-address host0:9911

# faster malloc for the append/itemize hot path; skip silently if absent
_TCMALLOC=/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4
if [ -f "$_TCMALLOC" ]; then
  export LD_PRELOAD="$_TCMALLOC"
fi
export TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD=60000000000
