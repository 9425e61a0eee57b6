"""Match/player store: the reference's MySQL object graph, in memory.

The reference reflects its schema at runtime with SQLAlchemy automap
(``worker.py:38-83``): match -> rosters -> participants -> player /
participant_items, plus ``asset`` rows holding telemetry URLs. This store
keeps the same duck-typed object graph (the shape ``rate_match`` and the
parity tests consume) keyed by api_id, with the reference's query contract:
``load_batch(ids)`` dedupes and returns matches ordered by ``created_at``
ascending — the load-bearing ordering of ``worker.py:172,176``.

The port's copy of ``analyzer_tpu.service.store``.
"""

from __future__ import annotations

from typing import Iterable


class UncloneableStoreError(RuntimeError):
    """The store can never provide a second connection (e.g. in-memory
    sqlite — a new connection sees a different empty database). Raised by
    ``clone()``; the worker treats it as a PERMANENT refusal and disables
    pipelined mode for its lifetime, unlike transient construction
    failures (DB blips), which retry with backoff."""


class InMemoryStore:
    def __init__(self) -> None:
        self.matches: dict[str, object] = {}
        self.assets: dict[str, list[str]] = {}  # match_api_id -> telemetry URLs
        self.players: dict[str, object] = {}

    def add_match(self, match) -> None:
        self.matches[match.api_id] = match
        for p in match.participants:
            player = p.player[0]
            self.players.setdefault(player.api_id, player)

    def add_asset(self, match_api_id: str, url: str) -> None:
        self.assets.setdefault(match_api_id, []).append(url)

    def load_batch(self, ids: Iterable[str]) -> list:
        """Dedupe + chronological order, the ``worker.py:172,176`` contract.
        Unknown ids are skipped (the reference's query simply returns no row
        for them)."""
        seen = dict.fromkeys(ids)  # preserves order, dedupes
        found = [self.matches[i] for i in seen if i in self.matches]
        return sorted(found, key=lambda m: m.created_at)

    def asset_urls(self, match_api_id: str) -> list[str]:
        """The telesuck query: ``SELECT url FROM asset WHERE match_api_id=?``
        (``worker.py:125,150-153``)."""
        return list(self.assets.get(match_api_id, ()))
