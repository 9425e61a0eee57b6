"""The benchmark's CSV export: every row, read back by Python's csv module,
is the match it was written from, and the program's columnar decode of
the bytes gives the generator's arrays."""

import csv
import io

import numpy as np
import pytest

from _tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)
from portbench import export, gen


def history(matches=9000, players=1500, seed=2**33 + 3):
    p = gen.make_players(players, seed, "cpu")
    return gen.make_stream(matches, p["latent"], seed, 0.8, 1e-3,
                           afk_rate=0.05, unsupported_rate=0.05, chunk=4000)


def parse(data: bytes):
    rows = list(csv.reader(io.StringIO(data.decode())))
    assert tuple(rows[0]) == ("match_id", "mode", "winner", "afk", "team0", "team1")
    return rows[1:]


@pytest.mark.parametrize("block_rows", [1000, 4096, 10**6])
def test_rows_read_back_through_the_csv_module(block_rows):
    s = history()
    data = export.stream_csv(s, "cpu", block_rows=block_rows)
    assert data.endswith(b"\n") and b"\r" not in data and b'"' not in data
    rows = parse(data)
    assert len(rows) == s["winner"].shape[0]
    names = (export.UNSUPPORTED,) + export.MODE_NAMES
    for i, row in enumerate(rows):
        assert int(row[0]) == i
        assert row[1] == names[s["mode_id"][i] + 1]
        assert (int(row[2]), int(row[3])) == (s["winner"][i], int(s["afk"][i]))
        for t in (0, 1):
            ids = s["player_idx"][i, t]
            assert [int(x) for x in row[4 + t].split(";")] == ids[ids >= 0].tolist()


def test_a_slice_keeps_its_match_ids():
    s = history(matches=3000)
    whole = parse(export.stream_csv(s, "cpu"))
    tail = parse(export.stream_csv(s, "cpu", lo=2000))
    assert tail == whole[2000:]


def test_the_programs_decode_gives_the_arrays():
    from analyzer_tpu_torch.io.ingest import decode_stream_csv

    s = history()
    got = decode_stream_csv(export.stream_csv(s, "cpu"))
    assert got is not None  # the native grammar takes the export whole
    t = got.player_idx.shape[2]
    assert np.array_equal(got.player_idx, s["player_idx"][:, :, :t])
    assert (s["player_idx"][:, :, t:] < 0).all()
    for key in ("winner", "mode_id", "afk"):
        assert np.array_equal(getattr(got, key), s[key]), key
