"""Shard-pure matchmaking: the fabric's determinism keystone.

The port's copy of ``analyzer_tpu.fabric.matchmaker``: the same
substreams, so the same formations on the same served ratings.

The broker partitions by the FIRST team-A row's shard (``x-partition``);
a host consumes only its owned partitions. If a match could mix rows
from two shards, the ingest routing would have to pick ONE owner and the
other host's rows would be rated remotely — cross-host write traffic,
ordering hazards, topology-dependent bits. The fabric forbids the case
at formation time instead: every match is SHARD-PURE (all ``2t``
participants drawn from one shard), so ``partition_of == shard
ownership`` routes every match to the one host that owns every row it
touches.

Shard-purity is also what makes the deterministic block bit-identical
across host counts: the parent soak driver runs ONE
:class:`ShardMatchmaker` per shard with a per-shard seeded substream
(``SeedSequence(entropy=seed, spawn_key=(3, shard))``) and iterates
shards in a fixed order — the (tick, shard) -> matches map is a pure
function of (seed, config), independent of how many hosts the shards
land on. Within a shard the sampling math is the base
:class:`~analyzer_tpu_torch.loadgen.matchmaker.Matchmaker`'s, applied to the
shard's own Zipf activity ladder over its ``r % S == shard`` rows.
"""

from __future__ import annotations

import numpy as np

from analyzer_tpu_torch.io.synthetic import AliasSampler
from analyzer_tpu_torch.loadgen.matchmaker import RATINGS_PAGE, Matchmaker


class ShardMatchmaker(Matchmaker):
    """A matchmaker whose candidate pool is ONE shard's rows.

    ``sample_rows`` returns GLOBAL row indices (all satisfying
    ``row % n_shards == shard``), so everything downstream — id
    formation, the served-rating sweep, split scoring through the
    routed winprob path — is the base class unchanged. The formation
    stream is the per-shard substream ``spawn_key=(3, shard)``; two
    fabrics with the same (seed, shard) draw identical candidates no
    matter the host count.
    """

    def __init__(
        self,
        players,
        client,
        shard: int,
        n_shards: int,
        seed: int = 0,
        cfg=None,
        activity_concentration: float = 1.2,
        team5_frac: float = 0.3,
        ratings_page: int = RATINGS_PAGE,
    ) -> None:
        super().__init__(
            players,
            client,
            seed=seed,
            cfg=cfg,
            activity_concentration=activity_concentration,
            team5_frac=team5_frac,
            ratings_page=ratings_page,
        )
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} outside 0..{n_shards - 1}")
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        # The shard's global rows, ascending — the candidate universe.
        self.shard_rows = np.arange(
            shard, players.n_players, n_shards, dtype=np.int64
        )
        if len(self.shard_rows) < 2 * 5:
            raise ValueError(
                f"shard {shard} holds {len(self.shard_rows)} of "
                f"{players.n_players} players; need at least 10 to form a "
                "5v5 — raise n_players or lower n_shards"
            )
        # Replace the base formation stream and sampler with the
        # per-shard substream + the shard's own Zipf activity ladder
        # (shuffled by THIS stream, so "who is the shard's grinder" is a
        # pure function of (seed, shard)).
        self.rng = np.random.default_rng(
            np.random.SeedSequence(entropy=seed, spawn_key=(3, shard))
        )
        ranks = np.arange(1, len(self.shard_rows) + 1, dtype=np.float64)
        weights = 1.0 / ranks**activity_concentration
        self.rng.shuffle(weights)
        self.sampler = AliasSampler(weights / weights.sum())

    def sample_rows(self, k: int, rng=None) -> list[int]:
        """``k`` DISTINCT global rows of THIS shard by activity weight,
        in draw order — the base redraw loop over shard-local draws,
        mapped through ``shard_rows`` to global indices."""
        rng = self.rng if rng is None else rng
        out: dict[int, None] = {}
        while len(out) < k:
            for c in self.sampler.draw(rng, (k,)).tolist():
                if len(out) == k:
                    break
                out.setdefault(int(self.shard_rows[int(c)]), None)
        return list(out)
