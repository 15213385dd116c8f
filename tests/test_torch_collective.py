"""The port's fleet collectives (``repro_torch.core.collective``): the
loopback collective, and ``FleetCollective`` over a real
``torch.distributed.TCPStore`` with 2-3 threads posing as processes —
round ordering, ``allreduce_sum``, ``agree`` raising ``FleetDesyncError``,
``FleetTimeout`` with a missing peer at a short deadline, round garbage
collection, a payload chunked across store values, and object payloads
loaded restricted."""

import pickle
import socket
import threading
from datetime import timedelta

import numpy as np
import pytest
from torch.distributed import TCPStore

from repro_torch.core.collective import (
    FleetCollective,
    FleetDesyncError,
    FleetTimeout,
    LoopbackCollective,
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fleet(nproc, **kw):
    port = _free_port()
    stores = [TCPStore("127.0.0.1", port, nproc, i == 0, timedelta(seconds=20),
                       wait_for_workers=False) for i in range(nproc)]
    return stores, [FleetCollective(store=stores[i], pid=i, nproc=nproc, **kw)
                    for i in range(nproc)]


def _run(colls, worker):
    outs, errs = [None] * len(colls), [None] * len(colls)

    def run(i):
        try:
            outs[i] = worker(i, colls[i])
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errs[i] = exc

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(colls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(errs), errs
    return outs


def test_loopback_is_the_identity():
    c = LoopbackCollective()
    np.testing.assert_array_equal(c.allreduce_sum(np.arange(4)), np.arange(4))
    assert c.allgather(b"x") == [b"x"]
    assert c.allgather_obj({"a": 1}) == [{"a": 1}]
    assert c.agree(b"v") == b"v"
    c.barrier()
    assert c.stats() == {"nproc": 1, "pid": 0, "rounds": 5, "seconds": 0.0, "payload_bytes": 5}


@pytest.mark.parametrize("nproc", [2, 3])
def test_rounds_are_ordered_and_sum_exactly(nproc):
    _, colls = _fleet(nproc, timeout_s=20)

    def worker(p, c):
        got = [c.allgather(f"r{r}-p{p}".encode()) for r in range(6)]
        big = np.full(5, 2**40 + p, dtype=np.int64)
        return got, c.allreduce_sum(np.arange(7) * (p + 1)), c.allreduce_sum(big)

    for got, total, big in _run(colls, worker):
        assert got == [[f"r{r}-p{q}".encode() for q in range(nproc)] for r in range(6)]
        np.testing.assert_array_equal(total, np.arange(7) * sum(range(1, nproc + 1)))
        np.testing.assert_array_equal(big, np.full(5, nproc * 2**40 + sum(range(nproc))))
    assert all(c.rounds == 8 for c in colls)


def test_agree_raises_on_divergence():
    _, colls = _fleet(2, timeout_s=20)

    def worker(p, c):
        assert c.agree(b"same", what="watermark") == b"same"
        with pytest.raises(FleetDesyncError, match="digest diverged"):
            c.agree(f"value-{p}".encode(), what="digest")
        return True

    assert all(_run(colls, worker))


def test_missing_peer_times_out():
    _, colls = _fleet(3, timeout_s=0.5)

    def worker(p, c):
        with pytest.raises(FleetTimeout, match="p2 missed round 0"):
            c.barrier()
        return True

    assert all(_run(colls[:2], worker))


def test_wait_s_outlasts_the_round_deadline():
    """A peer waiting for its next command may wait past ``timeout_s``."""
    import time

    _, colls = _fleet(2, timeout_s=0.3)

    def worker(p, c):
        if p == 1:
            time.sleep(1.0)  # the frontend is busy for longer than a round's deadline
            return c.allgather(b"cmd")
        return c.allgather(b"idle", wait_s=30)

    assert _run(colls, worker) == [[b"idle", b"cmd"]] * 2


def test_rounds_are_garbage_collected():
    stores, colls = _fleet(2, timeout_s=20, chunk_bytes=64)

    def worker(p, c):
        for r in range(10):
            c.allgather(bytes([p]) * (200 if r % 2 else 10))  # chunked every other round
        return True

    _run(colls, worker)
    # only the last two rounds' keys stay: round n deletes round n-2's
    keys = stores[0].num_keys()
    two_rounds = 2 * (1 + 4) + 2 * 1  # round 9 chunked (4 chunks + header), round 8 not
    assert keys - two_rounds <= 1  # the store's own bookkeeping key


def test_large_payload_crosses_in_chunks():
    _, colls = _fleet(2, timeout_s=20, chunk_bytes=1 << 16)
    rows = np.random.default_rng(0).integers(0, 10, size=(20_000, 7))

    def worker(p, c):
        got = c.allgather_obj({"op": "append", "kw": {"rows": rows if p == 0 else None}})
        return got[0]["kw"]["rows"], c.chunked_rounds

    for got, chunked in _run(colls, worker):
        np.testing.assert_array_equal(got, rows)
    assert colls[0].chunked_rounds == 1 and colls[1].chunked_rounds == 0
    assert colls[0].stats()["payload_bytes"] > rows.nbytes


def test_counts_past_the_store_value_limit():
    """The store refuses a value over 8 MiB: a batch's int64 counts at the
    largest bucket (2**20 pairs) are 8 MiB alone, so they cross chunked."""
    _, colls = _fleet(2, timeout_s=30)
    m = 1 << 20

    def worker(p, c):
        return c.allreduce_sum(np.full(m, p + 1, dtype=np.int64))

    for total in _run(colls, worker):
        assert total.shape == (m,) and (total == 3).all()
    assert colls[0].chunked_rounds == colls[1].chunked_rounds == 1


class Foreign:
    pass


def test_object_payloads_load_restricted():
    stores, colls = _fleet(2, timeout_s=20)
    # a peer publishes a pickle naming a class outside repro_torch/numpy
    evil = pickle.dumps({"op": Foreign()})

    def worker(p, c):
        if p == 1:
            c.allgather(evil)
            return True
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            c.allgather_obj({"op": None})
        return True

    assert all(_run(colls, worker))
