"""Device-resident rating state and the structure-of-arrays match batch.

Counterpart of ``analyzer_tpu.core.state``, with the same packed layout:
all per-player state the rating step touches is ONE ``[P+1, 16]`` float32
table —

    cols 0..6   mu      (0 = shared ``trueskill``, 1..6 per-mode)
    cols 7..13  sigma   (same order)
    col  14     seed_mu     (precomputed ``get_trueskill_seed`` result)
    col  15     seed_sigma

so a superstep is one whole-row gather and one whole-row scatter, and a
row is 64 bytes. Conventions (load-bearing, as in the JAX package):

  * NaN encodes SQL NULL ("never rated") in the mu/sigma columns;
  * row ``n_players`` (the last) is the padding row: empty team slots and
    masked writes target it, so every shape stays static.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.core.seeding import trueskill_seed
from analyzer_tpu_torch.device import resolve_device

MAX_TEAM_SIZE = 5

# Packed-table column layout.
N_COLS = constants.N_RATING_COLS  # 7: shared + 6 modes
MU_LO, MU_HI = 0, N_COLS
SIGMA_LO, SIGMA_HI = N_COLS, 2 * N_COLS
COL_SEED_MU = 2 * N_COLS
COL_SEED_SIGMA = 2 * N_COLS + 1
TABLE_WIDTH = 2 * N_COLS + 2  # 16


@dataclasses.dataclass
class PlayerState:
    """Dense per-player rating state. Row ``n_players`` is the padding row.

    ``table`` is ``[P+1, 16]`` packed as in the module docstring; the raw
    seed features ride along for ingest and debugging (the rating step
    reads only the baked seed columns). ``seed_cfg`` records the
    RatingConfig whose UNKNOWN_PLAYER_SIGMA baked the seed columns; rating
    with another value is refused (None = unchecked)."""

    table: torch.Tensor
    rank_points_ranked: torch.Tensor
    rank_points_blitz: torch.Tensor
    skill_tier: torch.Tensor
    seed_cfg: RatingConfig | None = None

    @property
    def mu(self) -> torch.Tensor:
        return self.table[:, MU_LO:MU_HI]

    @property
    def sigma(self) -> torch.Tensor:
        return self.table[:, SIGMA_LO:SIGMA_HI]

    @property
    def n_players(self) -> int:
        return self.table.shape[0] - 1

    @property
    def pad_row(self) -> int:
        return self.table.shape[0] - 1

    @classmethod
    def create(
        cls,
        n_players: int,
        rank_points_ranked: np.ndarray | None = None,
        rank_points_blitz: np.ndarray | None = None,
        skill_tier: np.ndarray | None = None,
        cfg: RatingConfig | None = None,
        device=None,
    ) -> "PlayerState":
        """Fresh state: all ratings unset (NaN), seeds precomputed on the
        host (:func:`~analyzer_tpu_torch.core.seeding.trueskill_seed`).
        Missing rank points are NaN; missing skill tier is 0."""
        cfg = cfg or RatingConfig()
        p1 = n_players + 1

        def _feat(x, fill):
            out = np.full((p1,), fill, dtype=np.float64)
            if x is not None:
                out[:n_players] = np.asarray(x, dtype=np.float64)
            return out.astype(np.float32)

        tiers = np.zeros((p1,), dtype=np.int32)
        if skill_tier is not None:
            tiers[:n_players] = np.asarray(skill_tier, dtype=np.int32)
        rr = _feat(rank_points_ranked, np.nan)
        rb = _feat(rank_points_blitz, np.nan)
        seed_mu, seed_sigma = trueskill_seed(rr, rb, tiers, cfg)

        table = np.full((p1, TABLE_WIDTH), np.nan, dtype=np.float32)
        table[:, COL_SEED_MU] = seed_mu
        table[:, COL_SEED_SIGMA] = seed_sigma
        return cls.from_numpy(table, rr, rb, tiers, seed_cfg=cfg, device=device)

    @classmethod
    def from_numpy(
        cls,
        table: np.ndarray,
        rank_points_ranked: np.ndarray,
        rank_points_blitz: np.ndarray,
        skill_tier: np.ndarray,
        seed_cfg: RatingConfig | None = None,
        device=None,
    ) -> "PlayerState":
        """A state holding exactly these bits — e.g. the JAX package's
        ``np.asarray(state.table)`` and feature arrays — on ``device``."""
        dev = resolve_device(device)
        table = np.ascontiguousarray(table, dtype=np.float32)
        if table.ndim != 2 or table.shape[1] != TABLE_WIDTH:
            raise ValueError(
                f"table must be [P+1, {TABLE_WIDTH}], got {table.shape}"
            )
        p1 = table.shape[0]
        feats = {
            "rank_points_ranked": np.asarray(rank_points_ranked, np.float32),
            "rank_points_blitz": np.asarray(rank_points_blitz, np.float32),
            "skill_tier": np.asarray(skill_tier, np.int32),
        }
        for name, arr in feats.items():
            if arr.shape != (p1,):
                raise ValueError(f"{name} must be [{p1}], got {arr.shape}")
        return cls(
            table=torch.from_numpy(table.copy()).to(dev),
            rank_points_ranked=torch.from_numpy(
                feats["rank_points_ranked"].copy()).to(dev),
            rank_points_blitz=torch.from_numpy(
                feats["rank_points_blitz"].copy()).to(dev),
            skill_tier=torch.from_numpy(feats["skill_tier"].copy()).to(dev),
            seed_cfg=seed_cfg,
        )

    def set_rating(self, row: int, col: int, mu: float, sigma: float) -> "PlayerState":
        """Returns a copy with one (mu, sigma) pair written — ingest/tests."""
        table = self.table.clone()
        table[row, MU_LO + col] = mu
        table[row, SIGMA_LO + col] = sigma
        return dataclasses.replace(self, table=table)

    def clone(self) -> "PlayerState":
        """A copy whose table the runners may update in place."""
        return dataclasses.replace(self, table=self.table.clone())


@dataclasses.dataclass
class MatchBatch:
    """A batch of B two-team matches in structure-of-arrays layout.

    player_idx ``[B, 2, T]`` int rows (padding slots point at the padding
    row, or at slot 0 inside a fused window); slot_mask ``[B, 2, T]`` bool;
    winner ``[B]`` 0/1 index of the winning team; mode_id ``[B]`` index into
    MODES or -1 (unsupported); afk ``[B]`` bool (any AFK or a roster count
    other than two, ``rater.py:90-100``)."""

    player_idx: torch.Tensor
    slot_mask: torch.Tensor
    winner: torch.Tensor
    mode_id: torch.Tensor
    afk: torch.Tensor

    @property
    def supported(self) -> torch.Tensor:
        return self.mode_id >= 0

    @property
    def ratable(self) -> torch.Tensor:
        """Matches that get a rating update (``rater.py:102-106``: AFK
        matches only get quality=0 / any_afk=True side effects)."""
        return self.supported & ~self.afk
