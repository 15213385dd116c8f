"""``data.loaders.write_fimi`` against the reference's FIMI reader and
writer: the port writes and the reference's ``read_fimi`` reads, and the
reverse, byte-identical files, including padded (ragged) rows and a custom
pad value."""

import numpy as np
import pytest

from repro.data.loaders import read_fimi as ref_read_fimi, write_fimi as ref_write_fimi
from repro_torch.data.loaders import read_fimi, write_fimi


def _tables():
    rng = np.random.default_rng(4)
    dense = rng.integers(0, 50, size=(30, 7))
    ragged = rng.integers(0, 9, size=(25, 6))
    for i, n in enumerate(rng.integers(1, 6, size=25)):
        ragged[i, n:] = -1  # padded tail: a shorter transaction
    ragged[0, :] = [3, 1, 4, 1, 5, 9]  # the widest row stays full
    custom = np.where(rng.random((10, 4)) < 0.3, 99, rng.integers(0, 5, size=(10, 4)))
    custom[0] = [1, 2, 3, 4]
    return [("dense", dense, -1), ("ragged", ragged, -1), ("custom_pad", custom, 99)]


@pytest.mark.parametrize("label,table,pad", _tables(), ids=lambda x: x if isinstance(x, str) else "")
def test_write_fimi_round_trips_with_reference(tmp_path, label, table, pad):
    port_file, ref_file = tmp_path / "port.dat", tmp_path / "ref.dat"
    write_fimi(str(port_file), table, pad_value=pad)
    ref_write_fimi(str(ref_file), table, pad_value=pad)
    assert port_file.read_bytes() == ref_file.read_bytes()
    # a padded row comes back with its values first and the pad after them
    want = np.full_like(table, pad)
    for i, row in enumerate(table):
        vals = row[row != pad]
        want[i, :len(vals)] = vals
    np.testing.assert_array_equal(ref_read_fimi(str(port_file), pad_value=pad), want)
    np.testing.assert_array_equal(read_fimi(str(ref_file), pad_value=pad), want)
    np.testing.assert_array_equal(read_fimi(str(port_file), pad_value=pad),
                                  ref_read_fimi(str(ref_file), pad_value=pad))
