"""Tables for the device itemize's tests: the edge cases that the CPU tests
(``test_torch_itemize.py``, against the reference package) and the card's
(``test_torch_gpu.py``, which may not import JAX) both run."""

import dataclasses

import numpy as np

I64 = np.iinfo(np.int64)


def mixed(n, seed):
    """Both routes in one table: small-range columns beside wide ones."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, 4, size=(n, 3)),
        rng.integers(-(10**15), 10**15, size=(n, 2)),
        np.full((n, 1), 7),
        rng.integers(-3, 3, size=(n, 1)) * 10**6,
        rng.integers(0, 40, size=(n, 1)),  # dense at 1,000 rows, sorted at 33
    ], axis=1)


def _extremes(n, seed):
    rng = np.random.default_rng(seed)
    col = rng.choice(np.array([I64.min, I64.min + 1, -1, 0, 1, I64.max - 1, I64.max]), size=n)
    return np.stack([col, -np.abs(rng.integers(0, 50, size=n)), rng.integers(I64.min, I64.max, size=n,
                                                                             endpoint=True)], axis=1)


CASES = {
    "example_3_6": lambda n: np.array([[1, 2, 3, 4], [1, 2, 7, 4], [1, 6, 3, 4], [5, 2, 3, 4]]),
    "small_range": lambda n: np.random.default_rng(n).integers(0, 5, size=(n, 7)),
    "negative_and_int64_extremes": lambda n: _extremes(n, n + 1),
    "constant_columns": lambda n: np.tile(np.array([[0, -5, I64.max, I64.min]]), (n, 1)),
    "both_routes": lambda n: mixed(n, n + 2),
    "wide_table_45_cols": lambda n: np.random.default_rng(n + 3).integers(0, 3, size=(n, 45)),
    "uint32": lambda n: np.random.default_rng(n + 4).integers(0, 2**32, size=(n, 3), dtype=np.uint32),
    "uint16_fortran_order": lambda n: np.asfortranarray(
        np.random.default_rng(n + 5).integers(0, 2**16, size=(n, 3), dtype=np.uint16)),
    "int8": lambda n: np.random.default_rng(n + 6).integers(-128, 128, size=(n, 3), dtype=np.int8),
    "uint8_read_only": lambda n: _read_only(np.random.default_rng(n + 7).integers(0, 256, size=(n, 2),
                                                                                   dtype=np.uint8)),
}


def _read_only(a):
    a.flags.writeable = False
    return a


def assert_same_table(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert np.array_equal(a, b), f.name


ROWS = [1, 31, 32, 33, 1000]
