"""The match history as the CSV export an operator hands ``cli migrate``.

One row per match, in stream order (the upstream's ``ORDER BY created_at
ASC``, ``worker.py:176``), under a header line:

    match_id,mode,winner,afk,team0,team1

``match_id`` is the match's index in the history, ``mode`` the upstream's
game-mode string (``unsupported`` for a match of a mode the rater skips),
``winner`` 0 or 1, ``afk`` 0 or 1, and each team its players' row ids
joined by ``;``. Lines end in ``\\n``.

The writer is the benchmark's own and shares nothing with the program's
codec: each block of rows is laid out on ``device`` as a fixed-width byte
matrix (every field at its widest, digits computed by division) with a
mask of the bytes a row really has, and the masked bytes, in row-major
order, are the block's text. A 10M-match history takes one pass of a few
large operations a block.
"""

from __future__ import annotations

import numpy as np
import torch

#: Game-mode strings by mode id (the upstream rater's queues).
MODE_NAMES = ("casual", "ranked", "blitz", "br", "5v5_casual", "5v5_ranked")
#: The mode string of a match whose mode id is -1.
UNSUPPORTED = "unsupported"
HEADER = b"match_id,mode,winner,afk,team0,team1\n"

#: Rows laid out at once: the widest block's byte matrix and its digit
#: temporaries stay within a few GB of device memory.
BLOCK_ROWS = 1_000_000


def _width(max_value: int) -> int:
    return len(str(max(int(max_value), 0)))


def _digits(values: torch.Tensor, width: int):
    """Decimal digits of non-negative ``values`` as ``[..., width]`` ASCII
    codes, most significant first, and the mask of the digits written (no
    leading zeros; a zero keeps its one digit)."""
    pow10 = 10 ** torch.arange(width - 1, -1, -1, device=values.device,
                               dtype=torch.int64)
    v = values.to(torch.int64).clamp(min=0).unsqueeze(-1)
    codes = (v // pow10 % 10 + ord("0")).to(torch.uint8)
    return codes, (v >= pow10) | (pow10 == 1)


def _const(char: str, rows: int, device):
    return (torch.full((rows, 1), ord(char), dtype=torch.uint8, device=device),
            torch.ones(rows, 1, dtype=torch.bool, device=device))


def _team(pidx: torch.Tensor, width: int, last: str):
    """One team column: ``[k, 5]`` row ids (-1 = empty slot) as the live
    ids joined by ``;``, then ``last``."""
    k, slots = pidx.shape
    live = pidx >= 0
    codes, keep = _digits(pidx, width)
    keep = keep & live.unsqueeze(-1)
    nxt = torch.zeros_like(live)
    nxt[:, :-1] = live[:, 1:]
    sep = torch.full((k, slots, 1), ord(";"), dtype=torch.uint8, device=pidx.device)
    codes = torch.cat((codes, sep), -1).reshape(k, -1)
    keep = torch.cat((keep, (live & nxt).unsqueeze(-1)), -1).reshape(k, -1)
    end_codes, end_keep = _const(last, k, pidx.device)
    return torch.cat((codes, end_codes), -1), torch.cat((keep, end_keep), -1)


def _mode_table(device):
    names = (UNSUPPORTED,) + MODE_NAMES  # indexed by mode id + 1
    width = max(len(n) for n in names)
    codes = np.zeros((len(names), width), np.uint8)
    keep = np.zeros((len(names), width), bool)
    for i, name in enumerate(names):
        codes[i, :len(name)] = np.frombuffer(name.encode(), np.uint8)
        keep[i, :len(name)] = True
    return torch.from_numpy(codes).to(device), torch.from_numpy(keep).to(device)


def stream_csv(arrays: dict, device, lo: int = 0, hi: int | None = None,
               block_rows: int = BLOCK_ROWS) -> bytes:
    """The CSV export of matches ``[lo, hi)`` of a history in the stream
    layout (``gen.make_stream``: ``player_idx [n, 2, 5]``, ``winner``,
    ``mode_id``, ``afk``), with the header; ``match_id`` is the match's
    index in the whole history."""
    n = arrays["winner"].shape[0]
    hi = n if hi is None else hi
    pidx_all = arrays["player_idx"]
    id_width = _width(hi - 1)
    player_width = _width(pidx_all[lo:hi].max() if hi > lo else 0)
    mode_codes, mode_keep = _mode_table(device)
    parts = [HEADER]
    for b0 in range(lo, hi, block_rows):
        b1 = min(hi, b0 + block_rows)
        k = b1 - b0
        ids = torch.arange(b0, b1, device=device)
        pidx = torch.from_numpy(pidx_all[b0:b1]).to(device)
        mode = torch.from_numpy(arrays["mode_id"][b0:b1]).to(device).long() + 1
        winner = torch.from_numpy(arrays["winner"][b0:b1]).to(device)
        afk = torch.from_numpy(arrays["afk"][b0:b1]).to(device).to(torch.int64)
        comma = _const(",", k, device)
        fields = [
            _digits(ids, id_width), comma,
            (mode_codes[mode], mode_keep[mode]), comma,
            _digits(winner, 1), comma,
            _digits(afk, 1), comma,
            _team(pidx[:, 0], player_width, ","),
            _team(pidx[:, 1], player_width, "\n"),
        ]
        codes = torch.cat([c for c, _ in fields], -1)
        keep = torch.cat([m for _, m in fields], -1)
        parts.append(codes[keep].cpu().numpy().tobytes())
    return b"".join(parts)
