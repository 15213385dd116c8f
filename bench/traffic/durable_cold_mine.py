"""Traffic driver ``durable_cold_mine``: cold mines on the durable service.

Set-up builds one durable service per table,
``repro_torch.service.MiningService.from_dataset(table, wal_dir=...)`` with
the configuration's ``service`` settings (a level checkpoint at every
level boundary, the WAL, the flight ring), ``wal_dir`` one directory per
table under the configuration's ``wal_root`` in the checkout. Each request
empties the service's result cache and asks ``mine(tau, kmax)``: the
service's cold mine (its preprocess kept per version, as a resident
service keeps it), with a job checkpoint at every level boundary. The
tables are ``cold_mine``'s: the configuration's generator, row order from
the run's seed.

After the window, :meth:`DurableColdMine.check` holds the service to its
guarantees, each count with the limit 0:

* ``answers_wrong``, ``levels_wrong``: the window's mines against the plain
  reference (``bench/reference/kyiv.py``), as ``cold_mine`` holds them;
* ``checkpoints_missing``: level boundaries of the window's mines with no
  ``job.checkpoint`` event in the service's flight ring (the service
  records it, fsync'd, once the checkpoint is saved), plus the faults of
  the checkpoint a killed mine leaves: table 0 mined again with the
  service's ``mine.level_end`` seam armed to raise ``KillPoint`` after
  level ``KILL_LEVEL``'s checkpoint, its newest checkpoint read back by a
  plain reader (``bench/reference/checkpoint.py``) against its manifest;
* ``resume_wrong``: a service rebuilt over that ``wal_dir`` with no table
  (the WAL restores it) that did not resume the killed job from level
  ``KILL_LEVEL + 1``, did not restore every row, or served another answer
  or level counts than the reference's. A cold re-mine gives the right
  answer too, so the resume itself is required.

The run removes its ``wal_root`` at the end.
"""

from __future__ import annotations

import atexit
import gc
import os
import shutil
import time
import traceback
from pathlib import Path

from bench import load_module
from bench.reference import checkpoint as plain_checkpoint
from bench.reference import kyiv as reference

__all__ = ["DurableColdMine", "KILL_LEVEL", "make"]

ROOT = Path(__file__).resolve().parents[2]
KILL_LEVEL = 3  # the killed mine dies after this level's checkpoint
cold = load_module(Path(__file__).resolve().parent / "cold_mine.py")


def _record(which: int, resp, w0: float, w1: float) -> dict:
    """What the check reads of one answer (``cold_mine``'s record, plus the
    answer's source and the wall-clock interval its ring events fall in)."""
    res = resp.result
    table = res.prep.table
    return {
        "table": which,
        "itemsets": res.itemsets,
        "stats": cold._stat_tuples(res.stats),
        "col": table.col,
        "value": table.value,
        "words": int(table.n_words),
        "completed": res.completed,
        "source": resp.source,
        "wall": (w0, w1),
    }


def _ring_events(flight, kind: str) -> list[dict]:
    """The events of one kind in a service's flight ring on disk (this
    incarnation's two segments)."""
    from repro_torch.obs.flight import read_segment

    flight.flush()
    events = []
    for side in ("a", "b"):
        evs, _torn = read_segment(os.path.join(flight.directory, f"inc{flight.incarnation}.{side}"))
        events += [e for e in evs if e.get("kind") == kind]
    return events


class DurableColdMine:
    def __init__(self, tables, config, service_kw: dict, root: Path, warmup_rounds: int,
                 tau: int, kmax: int, on_card: bool):
        from repro_torch.service import MiningService
        from repro_torch.service.faults import FaultInjector

        self.tables, self.config, self.service_kw = tables, config, service_kw
        self.root, self.warmup_rounds, self.tau, self.kmax = root, warmup_rounds, tau, kmax
        self.on_card = on_card
        shutil.rmtree(root, ignore_errors=True)
        atexit.register(shutil.rmtree, root, True)
        self.dirs = [str(root / f"table{i}") for i in range(len(tables))]
        self.injectors = [FaultInjector() for _ in tables]
        self.services = [
            MiningService.from_dataset(t, wal_dir=d, config=config, fault_injector=inj, **service_kw)
            for t, d, inj in zip(tables, self.dirs, self.injectors)
        ]

    def warm_up(self) -> None:
        for _ in range(self.warmup_rounds):
            for svc in self.services:
                svc.cache.clear()
                svc.mine(tau=self.tau, kmax=self.kmax)

    def request(self, i: int) -> dict:
        """Empty table ``i % len(tables)``'s result cache, then mine: the
        service's cold mine with its job checkpoints."""
        which = i % len(self.tables)
        svc = self.services[which]
        svc.cache.clear()
        w0 = time.time()
        resp = svc.mine(tau=self.tau, kmax=self.kmax)
        return _record(which, resp, w0, time.time())

    # -- the check ----------------------------------------------------------

    def _checkpoints_missing(self, records: list[dict]) -> int:
        """Level boundaries of the window's mines (every level k >= 2 the
        mine ran) with no ``job.checkpoint`` event of that level in the
        mine's interval."""
        events = [_ring_events(svc.flight, "job.checkpoint") for svc in self.services]
        missing = 0
        for r in records:
            w0, w1 = r["wall"]
            seen = {e["level"] for e in events[r["table"]] if w0 <= e["t"] <= w1}
            missing += len({s[0] for s in r["stats"] if s[0] >= 2} - seen)
        return missing

    def _kill_and_resume(self) -> tuple[int, int, dict | None]:
        """Kill a mine of table 0 after level ``KILL_LEVEL``'s checkpoint,
        read that checkpoint back, and rebuild the service over its
        directory: ``(checkpoint faults, resume faults, the rebuilt
        service's answer record)``."""
        from repro_torch.service import MiningService
        from repro_torch.service.faults import KillPoint

        svc, wal_dir = self.services[0], self.dirs[0]
        svc.cache.clear()
        self.injectors[0].arm("mine.level_end", action="raise", after=KILL_LEVEL - 2,
                              exc=KillPoint(f"killed after level {KILL_LEVEL}'s checkpoint"))
        ckpt_faults = resume_faults = 0
        try:
            svc.mine(tau=self.tau, kmax=self.kmax)
            ckpt_faults += 1  # the seam never fired: no level-end after the checkpoint
        except KillPoint:
            pass
        except Exception:  # the mine failed before the kill: counted, and the check goes on
            traceback.print_exc()
            ckpt_faults += 1
        # the process dies here: the ring keeps what reached the disk
        svc.flight.halt()
        svc.close()
        self.services[0] = None
        gc.collect()

        jobs = os.path.join(wal_dir, "jobs")
        steps = []
        for job in (os.listdir(jobs) if os.path.isdir(jobs) else []):
            for name in os.listdir(os.path.join(jobs, job)):
                if name.startswith("ckpt_") and name[5:].isdigit():
                    steps.append((int(name[5:]), os.path.join(jobs, job, name)))
        if not steps or max(steps)[0] != KILL_LEVEL:
            ckpt_faults += 1
        else:
            ckpt_faults += len(plain_checkpoint.faults(max(steps)[1]))

        record = None
        try:
            svc2 = MiningService(wal_dir=wal_dir, config=self.config, **self.service_kw)
            try:
                w0 = time.time()
                resp = svc2.mine(tau=self.tau, kmax=self.kmax)
                record = _record(0, resp, w0, time.time())
                resume_faults += int(svc2.resumed_jobs != 1)
                resume_faults += int(resp.info.get("resumed_from_level") != KILL_LEVEL + 1)
                resume_faults += int(svc2.store.n_rows != len(self.tables[0]))
            finally:
                svc2.close()
        except Exception:  # a restart that fails is a resume that failed (no record: counted below)
            traceback.print_exc()
        return ckpt_faults, resume_faults, record

    def check(self, records: list[dict], device) -> dict[str, tuple[int, int]]:
        """Numbers compared, each ``(value, limit)``."""
        try:
            missing = self._checkpoints_missing(records)
            ckpt_faults, resume_wrong, resumed = self._kill_and_resume()
        finally:
            for svc in self.services:
                if svc is not None:
                    svc.close()
            self.services = []
            gc.collect()
            if self.on_card:
                import torch

                torch.cuda.empty_cache()
        want = {t: reference.mine(self.tables[t], self.tau, self.kmax, device=device)
                for t in sorted({r["table"] for r in records} | {0})}
        answers_wrong = levels_wrong = 0
        for r in records:
            a, lv = _wrong(r, want[r["table"]], len(self.tables[r["table"]]))
            answers_wrong += a
            levels_wrong += lv
        if resumed is None:
            resume_wrong += 1
        else:
            resume_wrong += sum(_wrong(resumed, want[0], len(self.tables[0])))
        shutil.rmtree(self.root, ignore_errors=True)
        return {
            "answers_wrong": (answers_wrong, 0),
            "levels_wrong": (levels_wrong, 0),
            "checkpoints_missing": (missing + ckpt_faults, 0),
            "resume_wrong": (resume_wrong, 0),
        }


def _wrong(record: dict, ref, n_rows: int) -> tuple[int, int]:
    """(answer differs or stopped early, level counts differ) for one
    answer against the reference's for its table. The store pads its word
    axis to a tile of words, and a level's bytes count the rows at the
    table's width, so the reference's ``level_bytes`` (at ``ceil(n / 32)``
    words) is taken at the record's width; at the cell's 1,025,010 rows
    (32,032 words) the two widths are equal."""
    got = cold._value_sets(record["itemsets"], record["col"], record["value"])
    exact = (n_rows + 31) // 32
    want = [s[:-1] + (s[-1] // exact * record["words"],) for s in ref.stats]
    return int(not record["completed"] or got != ref.itemsets), int(record["stats"] != want)


def make(cfg: dict, mix: dict, seed: int, *, engine: str | None = None,
         device: str | None = None) -> DurableColdMine:
    """The mix's tables and one durable service per table. ``engine`` and
    ``device`` override the configuration's program settings (CPU tests
    only)."""
    from repro_torch.core.kyiv import KyivConfig

    program = dict(cfg.get("program", {}))
    if engine is not None:
        program.update(engine=engine, device=device)
    config = KyivConfig(tau=cfg["tau"], kmax=cfg["kmax"], **program)
    return DurableColdMine(
        tables=cold.tables(cfg, mix, seed), config=config, service_kw=dict(cfg["service"]),
        root=ROOT / cfg["wal_root"], warmup_rounds=mix["warmup_rounds"], tau=cfg["tau"],
        kmax=cfg["kmax"], on_card=device is None or str(device).startswith("cuda"))
