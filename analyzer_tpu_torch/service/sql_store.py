"""SQL match store: the reference's reflected-MySQL layer on raw DB-API.

The reference's L2 is SQLAlchemy automap — the schema is *reflected at
runtime*, never declared in code (``worker.py:43-46``), then the match →
roster → participant → player / participant_items graph is eager-loaded
with ``selectinload`` and written back with one transaction per batch
(``worker.py:169-199``). This adapter keeps every one of those contracts on
plain DB-API 2.0 instead of SQLAlchemy (not installed in this image; an ORM
wrapper would be dead code the tests can never run — the fate the round-1
review flagged for the pika adapter):

  * runtime reflection — table/column sets are discovered from the live
    database (``PRAGMA table_info`` / ``SHOW COLUMNS``), so the loaded
    column set and the write-back column set adapt to the deployed schema
    exactly as automap does; rating columns the schema lacks are silently
    dropped at commit, which is literally automap's behavior (setattr of a
    non-column name is a plain Python attribute the ORM never flushes).
  * selectin eager loading — one query per relationship level keyed by the
    parent ids (``worker.py:176-191``'s ``selectinload`` chain), matches
    ordered by ``created_at`` ascending, ids deduped (``worker.py:172,176``).
  * single-transaction write-back — ``commit()`` flushes every rating
    column of the loaded graph with ``executemany`` and commits once;
    any error rolls back and re-raises (``worker.py:194-199``).
  * ``asset_urls`` — the telesuck query (``SELECT url FROM asset WHERE
    match_api_id = ?``, ``worker.py:150-153``), autocommit read like the
    reference's separate throwaway session (``worker.py:124-126``).

Drivers: ``sqlite://`` URIs use the stdlib ``sqlite3`` (what the tests
exercise end-to-end); ``mysql://`` URIs try the reference's cymysql pin
first (``requirements.txt:1``), then pymysql/MySQLdb — gated imports, same
policy as the pika broker adapter.

Loaded objects are ``types.SimpleNamespace`` graphs shaped exactly like the
parity-test fakes (``tests/fakes.py``; the reference's ``worker_test.py:6-63``
strategy), so the whole encode → rate → write_back path is indifferent to
whether a match came from SQL or memory.

The port's copy of ``analyzer_tpu.service.sql_store``. Everything here is
host code; the only device work is the final move of the player table:
:meth:`SqlStore.load_stream` bakes the seed columns on the host and builds
its ``PlayerState`` on the device it is given (``device=None`` = the card).
The native scanner (``csrc/fastsql.cc``) is built with g++ at first use;
every scan it serves and every fall back to the python scans is counted
(``sql.native_scans_total`` / ``sql.native_fallbacks_total``) and each
fallback logged, so a scanner that was meant to run cannot be hidden.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Iterable
from urllib.parse import urlparse, unquote

from analyzer_tpu_torch.core.constants import RATING_COLUMNS
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import get_registry

logger = get_logger(__name__)

# The de-facto feature schema of the rating path: the reference's load_only
# column lists (worker.py:176-191). 5v5 columns are absent there and filled
# by lazy loading at runtime in SQLAlchemy; here reflection adds whichever
# rating pairs the live schema actually has (an eager superset, documented
# divergence — there is no lazy loading without an ORM session).
MATCH_COLS = ("api_id", "game_mode", "created_at")
ROSTER_COLS = ("api_id", "match_api_id", "winner")
PARTICIPANT_COLS = (
    "api_id", "match_api_id", "roster_api_id",
    "player_api_id", "skill_tier", "went_afk",
)
PLAYER_BASE_COLS = ("api_id", "rank_points_ranked", "rank_points_blitz")

REQUIRED_TABLES = (
    "match", "asset", "roster", "participant", "participant_items", "player",
)


def _connect(uri: str):
    """Opens a DB-API connection + paramstyle marker for the URI."""
    parsed = urlparse(uri)
    scheme = parsed.scheme.split("+")[0]
    if scheme == "sqlite":
        import sqlite3

        # sqlite:///rel.db | sqlite:////abs.db | sqlite:// (in-memory).
        # A netloc (sqlite://host/x) is not a filesystem path — folding it
        # into one would silently open './host/x'; reject the unsupported
        # host form instead.
        if parsed.netloc:
            raise ValueError(
                f"sqlite URIs take no host: {uri!r} (use sqlite:///rel.db "
                "or sqlite:////abs.db)"
            )
        path = parsed.path or ""
        if path.startswith("/") and not path.startswith("//"):
            path = path[1:]
        elif path.startswith("//"):
            path = path[1:]
        conn = sqlite3.connect(path or ":memory:")
        # The pipelined worker reads on the consumer thread while its
        # writer thread commits on a clone()d connection; without a busy
        # timeout a reader colliding with a commit raises SQLITE_BUSY
        # instead of briefly waiting.
        conn.execute("PRAGMA busy_timeout = 30000")
        return conn, "qmark", "sqlite", (path or None)
    if scheme == "mysql":
        last: Exception | None = None
        for drv in ("cymysql", "pymysql", "MySQLdb"):
            try:
                mod = __import__(drv)
            except ImportError as err:  # gated like the pika adapter
                last = err
                continue
            conn = mod.connect(
                host=parsed.hostname or "localhost",
                port=parsed.port or 3306,
                user=unquote(parsed.username or ""),
                passwd=unquote(parsed.password or ""),
                db=parsed.path.lstrip("/"),
            )
            return conn, "format", "mysql", None
        raise ImportError(
            f"no MySQL driver available for {uri!r} (tried cymysql, pymysql, "
            f"MySQLdb — the reference pins cymysql, requirements.txt:1): {last}"
        )
    raise ValueError(f"unsupported DATABASE_URI scheme: {parsed.scheme!r}")


@dataclasses.dataclass
class ColumnarHistory:
    """:meth:`SqlStore.load_stream`'s result: the full history as tensors
    plus the id maps needed to write results back / trace provenance."""

    stream: object  # sched.MatchStream, chronological
    state: object  # core.PlayerState with DB priors + baked seeds
    match_ids: list  # stream position -> match api_id
    player_ids: list  # player row -> player api_id


class SqlStore:
    """Match store over a SQL database, satisfying the worker's store
    protocol (``load_batch``, ``asset_urls``) plus the transactional
    ``commit``/``rollback`` the reference performs per batch.

    ``chunk_size`` bounds per-query row batches (the IN-list split in
    ``_select_in``) — the DB-API analog of the reference's
    ``yield_per(CHUNKSIZE)`` row streaming (``worker.py:19,191``)."""

    def __init__(self, uri: str, chunk_size: int = 100) -> None:
        self.uri = uri
        self.chunk_size = max(int(chunk_size), 1)
        (self.conn, self._paramstyle, self._dialect,
         self._sqlite_path) = _connect(uri)
        self._native_sql: bool | None = None  # False once proven unbuildable
        self.columns = self._reflect()
        missing = [t for t in REQUIRED_TABLES if t not in self.columns]
        if missing:
            raise RuntimeError(
                f"schema reflection: required tables missing from {uri!r}: "
                f"{missing} (the reference reflects match/asset/roster/"
                "participant/participant_stats/participant_items/player, "
                "worker.py:50-83)"
            )
        # participant_stats is reflected but never loaded nor written —
        # the reference wires it (worker.py:75-78) and never touches it.
        self._rating_cols = {
            table: [
                c
                for col in RATING_COLUMNS
                for c in (f"{col}_mu", f"{col}_sigma")
                if c in self.columns[table]
            ]
            for table in ("player", "participant_items")
        }

    def enable_wal(self) -> bool:
        """SERVICE-LANE journal mode: WAL lets the consumer thread's
        selectin loads proceed WHILE the writer thread's clone commits
        (delete-journal commits take an exclusive lock that stalls
        readers — measured as the pipelined sqlite lane's contention
        floor) and roughly halves the per-batch commit (append to the
        log, no full-db journal). synchronous=NORMAL under WAL keeps
        integrity across app crashes and loses at most the last commits
        on an OS crash — the same at-least-once window the broker's
        redelivery already covers (an unacked batch re-rates
        idempotently).

        Called by ``Worker.__init__``, NOT at connect: WAL is the wrong
        trade for the BULK lane — the full-history scans and bulk
        write-back measured 1.7x slower under WAL (22.6 s vs 13.3 s
        load_stream at 1M matches, round 5; every read checks the
        wal/shm, and scattered bulk updates pay the write-twice
        amplification), and that lane is single-threaded with nothing to
        overlap. The pragma REPORTS failure instead of raising (returns
        the old mode); synchronous is relaxed only when WAL actually
        engaged — in rollback-journal mode NORMAL opens a power-loss
        corruption window, not just a lost-commit one. Returns whether
        WAL is active. Note the mode is a property of the database FILE:
        it persists for later connections until changed back."""
        if self._dialect != "sqlite" or self._sqlite_path is None:
            return False
        try:
            got = self.conn.execute("PRAGMA journal_mode = WAL").fetchone()
            if got and str(got[0]).lower() == "wal":
                self.conn.execute("PRAGMA synchronous = NORMAL")
                return True
        except Exception:  # pragma: no cover — e.g. network fs
            pass
        return False

    def clone(self) -> "SqlStore":
        """A second store handle on its OWN connection — the pipelined
        worker's writer thread commits through a clone while the consumer
        thread keeps loading (sqlite connections are bound to the thread
        that may use them; MySQL connections are not thread-safe either).
        In-memory sqlite cannot be cloned (a new connection sees a
        different empty database) nor shared across threads
        (``check_same_thread``) — raises UncloneableStoreError so the
        worker permanently falls back to the sequential loop instead of
        failing batches (transient failures retry instead)."""
        from analyzer_tpu_torch.service.store import UncloneableStoreError

        if self._dialect == "sqlite" and self._sqlite_path is None:
            raise UncloneableStoreError(
                "in-memory sqlite store cannot be used by the pipelined "
                "worker (no second connection can see it); use a "
                "file-backed database or PIPELINE=false"
            )
        return SqlStore(self.uri, chunk_size=self.chunk_size)

    # -- reflection -------------------------------------------------------
    def _reflect(self) -> dict[str, list[str]]:
        cur = self.conn.cursor()
        out: dict[str, list[str]] = {}
        if self._dialect == "sqlite":
            cur.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"
            )
            tables = [r[0] for r in cur.fetchall()]
            for t in tables:
                cur.execute(f'PRAGMA table_info("{t}")')
                out[t] = [r[1] for r in cur.fetchall()]
        else:
            cur.execute("SHOW TABLES")
            tables = [r[0] for r in cur.fetchall()]
            for t in tables:
                cur.execute(f"SHOW COLUMNS FROM `{t}`")
                out[t] = [r[0] for r in cur.fetchall()]
        cur.close()
        return out

    # -- query helpers ----------------------------------------------------
    def _ph(self, n: int) -> str:
        mark = "?" if self._paramstyle == "qmark" else "%s"
        return ",".join([mark] * n)

    def _q(self, name: str) -> str:
        return f'"{name}"' if self._dialect == "sqlite" else f"`{name}`"

    def _select_in(self, table: str, cols: Iterable[str], key: str,
                   values: list, order_by: str | None = None) -> list[tuple]:
        if not values:
            return []
        cols = list(cols)
        cur = self.conn.cursor()
        # Chunk the IN list (the reference bounds per-query row streaming
        # with yield_per(CHUNKSIZE), worker.py:19,191; huge IN lists are
        # the DB-API analog of that concern).
        step = self.chunk_size
        rows: list[tuple] = []
        for i in range(0, len(values), step):
            chunk = values[i : i + step]
            sql = (
                f"SELECT {', '.join(self._q(c) for c in cols)} "
                f"FROM {self._q(table)} "
                f"WHERE {self._q(key)} IN ({self._ph(len(chunk))})"
            )
            if order_by:
                sql += f" ORDER BY {self._q(order_by)} ASC"
            cur.execute(sql, chunk)
            rows.extend(cur.fetchall())
        cur.close()
        if order_by and len(values) > step:
            idx = cols.index(order_by)
            # NULL-safe merge of the per-chunk ORDER BYs: None cannot be
            # compared to str/datetime in python; sqlite sorts NULLs
            # first, so mirror that.
            # Tuple keys never compare the second element across the
            # None/non-None boundary (the bool decides), and equal Nones
            # need no ordering call.
            rows.sort(key=lambda r: (r[idx] is not None, r[idx]))
        return rows

    # -- store protocol ---------------------------------------------------
    def load_batch(self, ids: Iterable[str]) -> list:
        """Dedupe + load the eager object graph, matches ordered by
        ``created_at`` ascending (``worker.py:172,176-191``). Built from
        the SAME raw row bundle as the columnar lane
        (:meth:`load_batch_raw`) — one definition of the five selectin
        queries, so the two lanes cannot drift on the load-bearing
        arrival orders (roster arrival defines team 0/1, participant
        arrival defines slots)."""
        raw = self.load_batch_raw(ids)
        matches: list[SimpleNamespace] = []
        for api_id, game_mode, created_at in raw["match_rows"]:
            matches.append(SimpleNamespace(
                api_id=api_id, game_mode=game_mode, created_at=created_at,
                trueskill_quality=None, rosters=[], participants=[],
            ))

        by_match: dict[str, SimpleNamespace] = {m.api_id: m for m in matches}
        rosters: dict[str, SimpleNamespace] = {}
        for api_id, match_api_id, winner in raw["roster_rows"]:
            r = SimpleNamespace(
                api_id=api_id, match_api_id=match_api_id, winner=winner,
                participants=[],
            )
            rosters[api_id] = r
            by_match[match_api_id].rosters.append(r)

        part_rows = raw["part_rows"]
        # Absent schema columns read as None. Computed ONCE per batch:
        # the per-object hasattr probe over every rating pair cost ~90k
        # dynamic attribute checks per 500-match batch (~30% of
        # load_batch, profiled round 5) for an answer that is a property
        # of the reflected schema, not of any row.
        player_cols = raw["player_cols"]
        base = {"skill_tier": None}
        for col in RATING_COLUMNS:
            base[f"{col}_mu"] = None
            base[f"{col}_sigma"] = None
        players: dict[str, SimpleNamespace] = {}
        for row in raw["player_rows"]:
            p = SimpleNamespace(**base)
            p.__dict__.update(zip(player_cols, row))
            players[p.api_id] = p

        items_cols = raw["items_cols"]
        items_base = {}
        for col in RATING_COLUMNS[1:]:
            items_base[f"{col}_mu"] = None
            items_base[f"{col}_sigma"] = None
        items_by_part: dict[str, list[SimpleNamespace]] = {}
        for row in raw["items_rows"]:
            it = SimpleNamespace(**items_base)
            it.__dict__.update(zip(items_cols, row))
            items_by_part.setdefault(it.participant_api_id, []).append(it)

        for api_id, match_api_id, roster_api_id, player_api_id, skill_tier, went_afk in part_rows:
            part = SimpleNamespace(
                api_id=api_id,
                match_api_id=match_api_id,
                roster_api_id=roster_api_id,
                player_api_id=player_api_id,
                skill_tier=skill_tier,
                went_afk=went_afk,
                trueskill_mu=None,
                trueskill_sigma=None,
                trueskill_delta=None,
                player=[players[player_api_id]],
                participant_items=items_by_part.get(api_id, []),
            )
            by_match[match_api_id].participants.append(part)
            if roster_api_id in rosters:
                rosters[roster_api_id].participants.append(part)
        return matches

    # -- columnar batch lane ----------------------------------------------
    def load_batch_raw(self, ids: Iterable[str]):
        """The ONE implementation of the batch's five selectin queries
        (dedupe, created_at order, arrival orders), returned as raw row
        bundles. :class:`analyzer_tpu.service.columnar.ColumnarBatch`
        consumes them directly (no object graphs — on this package's
        1-core reference host the ~11k-SimpleNamespace build was the
        single largest python cost of the service loop, profiled round
        5); :meth:`load_batch` builds the duck-typed object graph from
        the same bundle. player.skill_tier is not in the reference's
        load_only list (worker.py:184-190) but get_trueskill_seed reads
        it lazily (rater.py:57-60); reflection loads it eagerly when it
        exists."""
        seen = list(dict.fromkeys(ids))
        match_rows = self._select_in(
            "match", MATCH_COLS, "api_id", seen, order_by="created_at"
        )
        mids = [r[0] for r in match_rows]
        roster_rows = self._select_in(
            "roster", ROSTER_COLS, "match_api_id", mids
        )
        part_rows = self._select_in(
            "participant", PARTICIPANT_COLS, "match_api_id", mids
        )
        player_ids = list(dict.fromkeys(r[3] for r in part_rows))
        player_cols = list(PLAYER_BASE_COLS) + self._rating_cols["player"]
        if "skill_tier" in self.columns["player"]:
            player_cols.insert(len(PLAYER_BASE_COLS), "skill_tier")
        player_rows = self._select_in("player", player_cols, "api_id", player_ids)
        items_cols = ["api_id", "participant_api_id", "any_afk"]
        items_cols += self._rating_cols["participant_items"]
        part_ids = [r[0] for r in part_rows]
        items_rows = self._select_in(
            "participant_items", items_cols, "participant_api_id", part_ids
        )
        return {
            "match_rows": match_rows,
            "roster_rows": roster_rows,
            "part_rows": part_rows,
            "player_cols": player_cols,
            "player_rows": player_rows,
            "items_cols": items_cols,
            "items_rows": items_rows,
            "schema_rating_cols": dict(self._rating_cols),
            # Full column sets of the write-target tables, so write_plan
            # can apply the object lane's filter-before-building rule
            # (columns the deployed schema lacks are dropped, exactly as
            # automap never flushes a non-column attribute).
            "schema_columns": {
                t: set(self.columns[t])
                for t in ("match", "participant", "player", "participant_items")
            },
        }

    def load_batch_native(self, ids: Iterable[str]):
        """[sqlite fastest path] The five batch queries through the C
        columnar scanner (``fastsql.cc``): columns arrive as typed numpy
        arrays with NO per-row python tuples — ``fetchall``'s tuple
        building was the largest single cost of the columnar lane's
        load (~58 ms of a 500-match batch, profiled round 5 on-rig).
        Returns an array-form bundle for :class:`ColumnarBatch`, or None
        when the native layer is unavailable (file-less DB, no g++, scan
        failure, an id the literal quoting cannot carry) — callers fall
        back to :meth:`load_batch_raw`.

        Ties in ``created_at`` may order differently than the python
        lane's chunked merge (both are within the reference's
        unspecified tie behavior, ``worker.py:176``); team/slot arrival
        orders can likewise differ for >CHUNKSIZE batches — all
        rating-output-neutral (the kernel is team-symmetric given the
        winner flag; outputs key by player)."""
        if self._sqlite_path is None or self._native_sql is False:
            return None
        seen = list(dict.fromkeys(ids))
        if not seen:
            return None  # empty loads take the (trivial) python path
        for v in seen:
            if "\x00" in str(v):
                return None  # a literal cannot carry NUL; bind path can
        inlist = ",".join("'" + str(v).replace("'", "''") + "'" for v in seen)
        q = self._q
        m = self._native_scan(
            f"SELECT {q('api_id')}, {q('game_mode')} FROM {q('match')} "
            f"WHERE {q('api_id')} IN ({inlist}) "
            f"ORDER BY {q('created_at')} ASC",
            [("api_id", "str"), ("game_mode", "str")],
        )
        if m is None:
            return None
        mid_list = ",".join(
            "'" + s.decode().replace("'", "''") + "'" for s in m["api_id"]
        )
        if not mid_list:
            mid_list = "''"
        ro = self._native_scan(
            f"SELECT {q('api_id')}, {q('match_api_id')}, {q('winner')} "
            f"FROM {q('roster')} WHERE {q('match_api_id')} IN ({mid_list})",
            [("api_id", "str"), ("match_api_id", "str"), ("winner", "int")],
        )
        pa = self._native_scan(
            f"SELECT {q('api_id')}, {q('match_api_id')}, "
            f"{q('roster_api_id')}, {q('player_api_id')}, {q('went_afk')} "
            f"FROM {q('participant')} "
            f"WHERE {q('match_api_id')} IN ({mid_list})",
            [("api_id", "str"), ("match_api_id", "str"),
             ("roster_api_id", "str"), ("player_api_id", "str"),
             ("went_afk", "int")],
        )
        if ro is None or pa is None:
            return None
        pid_set = dict.fromkeys(pa["player_api_id"].tolist())
        pid_list = ",".join(
            "'" + s.decode().replace("'", "''") + "'" for s in pid_set
        ) or "''"
        player_cols = list(PLAYER_BASE_COLS) + self._rating_cols["player"]
        if "skill_tier" in self.columns["player"]:
            player_cols.insert(len(PLAYER_BASE_COLS), "skill_tier")
        # Every non-id column as float: NULL -> NaN keeps a missing
        # skill_tier distinguishable from tier 0 for the out-of-table
        # gate (the scanner's int convention folds NULL into 0).
        spec = [("api_id", "str")] + [(c, "float") for c in player_cols[1:]]
        pl = self._native_scan(
            f"SELECT {', '.join(q(c) for c, _ in spec)} FROM {q('player')} "
            f"WHERE {q('api_id')} IN ({pid_list})",
            spec,
        )
        paid_list = ",".join(
            "'" + s.decode().replace("'", "''") + "'" for s in pa["api_id"]
        ) or "''"
        it = self._native_scan(
            f"SELECT {q('api_id')}, {q('participant_api_id')} "
            f"FROM {q('participant_items')} "
            f"WHERE {q('participant_api_id')} IN ({paid_list})",
            [("api_id", "str"), ("participant_api_id", "str")],
        )
        if pl is None or it is None:
            return None
        return {
            "match": m,
            "roster": ro,
            "participant": pa,
            "player": pl,
            "player_cols": player_cols,
            "items": it,
            "schema_rating_cols": dict(self._rating_cols),
            "schema_columns": {
                t: set(self.columns[t])
                for t in ("match", "participant", "player",
                          "participant_items")
            },
        }

    def commit_columnar(self, plan) -> None:
        """Array-lane counterpart of :meth:`commit`: flushes a
        :meth:`ColumnarBatch.write_plan` in one transaction. The plan
        writes ONLY touched columns/rows (exactly what the reference's
        ORM flush would — automap never writes unmodified attributes),
        which both shrinks the bind work and removes the object lane's
        stale-snapshot rewrite hazard under pipelining (columnar.py)."""
        try:
            cur = self.conn.cursor()
            mark = "?" if self._paramstyle == "qmark" else "%s"
            for table, cols, key, rows in plan:
                # No schema re-filtering here: the plan was built FROM
                # the reflected schema (load_batch_raw ships
                # schema_rating_cols), and rows are positional — dropping
                # a column without its values would shift every bind.
                if not rows or not cols:
                    continue
                sql = (
                    f"UPDATE {self._q(table)} SET "
                    + ", ".join(f"{self._q(c)} = {mark}" for c in cols)
                    + f" WHERE {self._q(key)} = {mark}"
                )
                cur.executemany(sql, rows)
            cur.close()
            self.conn.commit()
        except Exception:
            self.conn.rollback()
            raise

    # -- columnar full-history ingest -------------------------------------
    def _sqlite_bulk(
        self, table: str, str_cols: tuple, int_cols: tuple,
        float_cols: tuple = (), chunk_rows: int = 4_000_000,
    ) -> dict:
        """[sqlite fast path] Every row of ``table``, rowid-ordered, as
        numpy column arrays — WITHOUT per-row Python tuples.

        Each (rowid range, column) pair issues ONE ``group_concat``
        aggregate: the whole scan executes inside a single
        ``sqlite3_step`` call with no per-row Python (the classic
        fetchall path builds a tuple per row — measured 94 s for 7.3M
        participant rows on the 1M-match fixture vs ~10 s this way; the
        indexed-JOIN alternative was 128 s). Alignment is safe by
        construction: a rowid-range query walks the table b-tree in rowid
        order, and every nullable column is COALESCEd so no accumulator
        skips a row — the per-chunk length check still guards it.
        Chunking keeps each concat far below SQLITE_MAX_LENGTH and bounds
        peak memory.
        """
        import sqlite3

        import numpy as np

        q = self._q
        cur = self.conn.cursor()
        cur.execute(f"SELECT MIN(rowid), MAX(rowid) FROM {q(table)}")
        lo, hi = cur.fetchone()
        cur.close()
        empty = {c: np.empty(0, "S1") for c in str_cols}
        empty.update({c: np.empty(0, np.int64) for c in int_cols})
        empty.update({c: np.empty(0, np.float64) for c in float_cols})
        if lo is None:
            return empty
        # Row order: a `WHERE rowid BETWEEN` range query walks the table
        # b-tree itself, which IS rowid order — no per-row rowid column
        # needed (concatenating one would double the aggregate work). The
        # per-column buffers of one chunk therefore align by construction;
        # the length check below still guards it (COALESCE keeps every
        # accumulator from skipping NULL rows).
        ranges = [
            (a, min(a + chunk_rows - 1, hi))
            for a in range(lo, hi + 1, chunk_rows)
        ]
        cols = [*str_cols, *int_cols, *float_cols]

        # One extra connection for the scans (bytes text factory without
        # disturbing the main connection); :memory: databases fall back
        # to the main connection — their data is invisible to new ones.
        # Scans run SEQUENTIALLY on purpose: concurrent readers of one
        # sqlite file anti-scale (measured on the 1M-match fixture: the
        # participant scans took 9.6 s serial, 24 s with two threads,
        # 30 s with three — contention swamps the extra core).
        if self._sqlite_path is not None:
            conn = sqlite3.connect(self._sqlite_path)
        else:
            conn = self.conn
        prev_factory = conn.text_factory
        conn.text_factory = bytes
        by_col: dict[str, list[np.ndarray]] = {c: [] for c in cols}
        try:
            c = conn.cursor()
            for ri, _ in enumerate(ranges):
                sizes = set()
                for col in cols:
                    # 'nan' for float columns: numpy's float parser turns
                    # it back into NaN, so SQL NULL round-trips without a
                    # sparse query.
                    fill = (
                        "''" if col in str_cols
                        else "0" if col in int_cols else "'nan'"
                    )
                    c.execute(
                        f"SELECT group_concat(COALESCE({q(col)}, {fill}), "
                        f"x'0a') FROM {q(table)} WHERE rowid BETWEEN ? AND ?",
                        ranges[ri],
                    )
                    buf = c.fetchone()[0]
                    if buf is None:
                        sizes.add(0)
                        continue
                    # Parse IMMEDIATELY so the raw text buffer frees per
                    # column — peak memory is one column's text plus the
                    # arrays, not every buffer at once.
                    raw = buf.split(b"\n")
                    del buf
                    sizes.add(len(raw))
                    dt = (
                        None if col in str_cols
                        else np.int64 if col in int_cols else np.float64
                    )
                    by_col[col].append(
                        np.array(raw) if dt is None else np.array(raw, dt)
                    )
                if len(sizes) > 1:  # COALESCE guarantees alignment; fail loudly
                    raise RuntimeError(
                        f"bulk scan of {table}: misaligned column lengths "
                        f"{sizes}"
                    )
            c.close()
        finally:
            if conn is not self.conn:
                conn.close()
            else:
                conn.text_factory = prev_factory
        if not any(by_col[c] for c in cols):
            return empty
        return {c: np.concatenate(by_col[c]) for c in cols}

    def _generic_bulk(
        self, table: str, str_cols: tuple, int_cols: tuple,
        float_cols: tuple = (),
    ) -> dict:
        """Portable bulk fetch (MySQL): plain SELECT ordered by api_id —
        no rowid exists, so arrival order is the primary key (documented
        ordering divergence of the bulk path on MySQL)."""
        import numpy as np

        q = self._q
        cur = self.conn.cursor()
        cols = [*str_cols, *int_cols, *float_cols]
        cur.execute(
            f"SELECT {', '.join(q(c) for c in cols)} FROM {q(table)} "
            f"ORDER BY {q('api_id')} ASC"
        )
        rows = cur.fetchall()
        cur.close()
        out = {}
        for i, c in enumerate(str_cols):
            out[c] = np.array([r[i] or "" for r in rows]) if rows else np.empty(0, "U1")
        base = len(str_cols)
        for i, c in enumerate(int_cols):
            out[c] = (
                np.fromiter((r[base + i] or 0 for r in rows), np.int64, len(rows))
                if rows else np.empty(0, np.int64)
            )
        base += len(int_cols)
        for i, c in enumerate(float_cols):
            out[c] = (
                np.fromiter(
                    (np.nan if r[base + i] is None else r[base + i] for r in rows),
                    np.float64, len(rows),
                )
                if rows else np.empty(0, np.float64)
            )
        return out

    def _native_scan(self, sql: str, cols: list) -> "dict | None":
        """[sqlite fastest path] Arbitrary-query columnar scan through the
        C sqlite reader (``fastsql.cc``): one b-tree walk per pass with no
        per-row Python and no text round-trip for numeric columns —
        measured ~4x faster than the group_concat scan on the 1M-match
        fixture. Opens the database read-only BY PATH, so it sees
        committed data only (the same visibility as ``_sqlite_bulk``'s
        second connection). Returns None when the native layer is
        unavailable or the scan fails (callers fall back to the python
        scans); in-memory databases never take this path.
        """
        if self._sqlite_path is None or self._native_sql is False:
            return None
        from analyzer_tpu_torch.service import _native_sql

        reg = get_registry()
        try:
            _native_sql.load()
        except ImportError as e:
            self._native_sql = False  # no g++ / unloadable .so: stop trying
            reg.counter("sql.native_fallbacks_total").add(1)
            logger.warning("native sqlite scanner unavailable (%s); "
                           "using python bulk scans", e)
            return None
        try:
            out = _native_sql.scan_query(self._sqlite_path, sql, cols)
        except RuntimeError as e:  # db changed mid-scan, odd page, ...
            reg.counter("sql.native_fallbacks_total").add(1)
            logger.warning("native sqlite scan failed (%s); "
                           "falling back to python scan for: %s", e, sql)
            return None
        reg.counter("sql.native_scans_total").add(1)
        return out

    def _bulk(
        self, table: str, str_cols: tuple, int_cols: tuple = (),
        float_cols: tuple = (),
    ) -> dict:
        if self._dialect == "sqlite":
            q = self._q
            cols = (
                [(c, "str") for c in str_cols]
                + [(c, "int") for c in int_cols]
                + [(c, "float") for c in float_cols]
            )
            native = self._native_scan(
                f"SELECT {', '.join(q(c) for c, _ in cols)} FROM {q(table)} "
                f"ORDER BY rowid ASC",
                cols,
            )
            if native is not None:
                return native
            return self._sqlite_bulk(table, str_cols, int_cols, float_cols)
        return self._generic_bulk(table, str_cols, int_cols, float_cols)

    def load_stream(self, cfg=None, device=None) -> "ColumnarHistory":
        """Columnar DB -> tensor ingest: the full match history SELECTed
        straight into numpy arrays, no object graphs.

        ``load_batch`` + ``EncodedBatch`` are right for service batches of
        500; a full-history re-rate FROM the database (the reference's
        actual data source, ``worker.py:176-191``) would pay millions of
        SimpleNamespace allocations just to re-flatten them. Here the
        heavy tables stream out through :meth:`_bulk` (parallel
        GIL-releasing scans on sqlite), and all id -> dense-index mapping
        is vectorized numpy (``argsort`` + ``searchsorted`` over the id
        arrays; per-roster team numbers and per-team slots are grouped
        cumcounts). Matches are ordered by ``created_at`` ascending — the
        load-bearing order (``worker.py:176``) — with the database doing
        that one type-aware sort. Player priors/seed features fill the
        packed state table via sparse ``IS NOT NULL`` selects (NULL stays
        NaN).

        Documented divergences from the object path (all logged):
          * malformed matches — roster count != 2, team slot overflow,
            zero/two winner flags — are marked NON-RATABLE instead of
            raising; one corrupt record must not kill a 10M-match ingest
            (``EncodedBatch`` stays strict for service batches).
          * out-of-table skill tiers are clamped (tensor-path semantics);
            the object API's KeyError contract needs per-match gating
            this bulk path does not reconstruct.
          * dangling foreign keys (roster without its match, participant
            without its roster/player) are dropped, like the inner joins
            the object path's dict lookups amount to.

        Returns a :class:`ColumnarHistory` whose ``state`` lies on
        ``device`` (None = the card; asking for it without one raises
        before any scan runs); pass its ``state``/``stream`` to
        ``sched.rate_stream`` / ``rate_history`` and optionally write the
        final table back with :meth:`write_players`.
        """
        import numpy as np

        from analyzer_tpu_torch.config import RatingConfig
        from analyzer_tpu_torch.core import constants
        from analyzer_tpu_torch.core.seeding import trueskill_seed_host
        from analyzer_tpu_torch.core.state import (
            COL_SEED_MU, COL_SEED_SIGMA, MAX_TEAM_SIZE, MU_LO, SIGMA_LO,
            TABLE_WIDTH, PlayerState,
        )
        from analyzer_tpu_torch.device import resolve_device
        from analyzer_tpu_torch.sched.superstep import MatchStream

        device = resolve_device(device)
        cfg = cfg or RatingConfig()
        q = self._q
        sqlite = self._dialect == "sqlite"
        if sqlite and self._sqlite_path is not None:
            try:
                got = self.conn.execute("PRAGMA journal_mode").fetchone()
                if got and str(got[0]).lower() == "wal":
                    # A service worker owned this file at some point (the
                    # mode persists). The bulk scans measured ~1.7x
                    # slower under WAL — tell the operator rather than
                    # silently flipping their database's mode.
                    logger.warning(
                        "database is in WAL journal mode (set by a "
                        "service worker); the bulk ingest runs ~1.7x "
                        "faster under the rollback journal — consider "
                        "'PRAGMA journal_mode=DELETE' for large offline "
                        "re-rates (docs/OPERATIONS.md)"
                    )
            except Exception:  # pragma: no cover — advisory only
                pass
        cur = self.conn.cursor()

        def _decode(x):
            return x.decode() if isinstance(x, bytes) else x

        def _decode_list(arr) -> list:
            """Vectorized id-array -> list[str] (np.char.decode runs the
            utf-8 decode in a C loop; the per-element comprehension cost
            0.7 s at 1.3M ids)."""
            if arr.dtype.kind == "S":
                return np.char.decode(arr, "utf-8").tolist()
            return [_decode(x) for x in arr]

        native_join = None
        if sqlite and self._native_sql is not False:
            from analyzer_tpu_torch.service import _native_sql

            try:
                _native_sql.load()
                native_join = _native_sql.lookup
            except ImportError as e:
                # Latch like _native_scan does: a failed build would
                # otherwise re-spawn g++ for every fresh store.
                self._native_sql = False
                get_registry().counter("sql.native_fallbacks_total").add(1)
                logger.warning("native sqlite scanner unavailable (%s); "
                               "using numpy joins", e)

        def _join(ids, needles):
            """needle -> position in ``ids``; ok=False for misses. Native
            hash join when available (S-dtype ids), else the numpy
            argsort+searchsorted path — identical semantics, including
            smallest-index resolution of duplicate ids."""
            if (
                native_join is not None
                and ids.dtype.kind == "S"
                and needles.dtype.kind == "S"
            ):
                got = native_join(ids, needles)
                ok = got >= 0
                return np.where(ok, got, 0), ok
            sorted_ids, order = _index(ids)
            return _lookup(sorted_ids, order, needles)

        def _index(ids):
            """Sorted view of an id array for searchsorted lookups."""
            order = np.argsort(ids, kind="stable")
            return ids[order], order

        def _lookup(sorted_ids, order, needles):
            """needle -> position in the ORIGINAL id array; ok=False for
            misses (dangling foreign keys)."""
            if sorted_ids.size == 0 or needles.size == 0:
                return (np.zeros(needles.shape, np.int64),
                        np.zeros(needles.shape, bool))
            pos = np.searchsorted(sorted_ids, needles)
            pos = np.minimum(pos, sorted_ids.size - 1)
            got = order[pos]
            return got, sorted_ids[pos] == needles

        def _cumcount(keys, minlength=None):
            """Occurrence index of each element within its key group,
            preserving arrival order (stable). ``minlength`` bounds the
            key values and routes through the native single-pass counter
            when available — unless the bound is degenerate (a malformed
            match with hundreds of rosters inflates the slot stride, and
            with it the dense counter) or the allocation fails; the numpy
            path's cost is independent of the key range."""
            if keys.size == 0:
                return np.zeros(0, np.int64)
            if (
                native_join is not None
                and minlength is not None
                and minlength <= 16 * keys.size
            ):
                try:
                    return _native_sql.cumcount(keys, minlength)
                except RuntimeError as e:
                    logger.warning(
                        "native cumcount failed (%s); using numpy path", e
                    )
            order = np.argsort(keys, kind="stable")
            sk = keys[order]
            first = np.r_[True, sk[1:] != sk[:-1]]
            start = np.maximum.accumulate(
                np.where(first, np.arange(sk.size), 0)
            )
            out = np.empty(sk.size, np.int64)
            out[order] = np.arange(sk.size) - start
            return out

        # -- matches: the one type-aware sort the database owns ----------
        tie = "rowid" if sqlite else q("api_id")
        match_sql = (
            f"SELECT {q('api_id')}, {q('game_mode')} FROM {q('match')} "
            f"ORDER BY {q('created_at')} ASC, {tie} ASC"
        )
        native = (
            self._native_scan(
                match_sql, [("api_id", "str"), ("game_mode", "str")]
            ) if sqlite else None
        )
        if native is not None:
            m_ids = native["api_id"]
            modes = native["game_mode"]
            n = int(m_ids.size)
        else:
            # The bytes factory window is scoped to THIS fetch
            # (try/finally): leaking it past an exception would leave
            # every later load_batch/asset_urls on this store returning
            # bytes ids.
            if sqlite:
                prev_factory = self.conn.text_factory
                self.conn.text_factory = bytes
            try:
                cur.execute(match_sql)
                m_rows = cur.fetchall()
            finally:
                if sqlite:
                    self.conn.text_factory = prev_factory
            n = len(m_rows)
            nil = b"" if sqlite else ""
            m_ids = (
                np.array([r[0] for r in m_rows]) if n else np.empty(0, "S1")
            )
            modes = (
                np.array([r[1] or nil for r in m_rows])
                if n else np.empty(0, "S1")
            )
            del m_rows
        mode_id = np.full(n, constants.UNSUPPORTED_MODE_ID, np.int32)
        for name, mid in constants.MODE_TO_ID.items():
            key = name.encode() if sqlite else name
            mode_id[modes == key] = mid
        del modes

        # -- players: one bulk pass over every feature/prior column ------
        pcols = self.columns["player"]
        p_int = tuple(c for c in ("skill_tier",) if c in pcols)
        p_float = tuple(
            c for c in ("rank_points_ranked", "rank_points_blitz")
            if c in pcols
        ) + tuple(self._rating_cols["player"])
        pl = self._bulk("player", ("api_id",), p_int, p_float)
        p_ids = pl["api_id"]
        p = int(p_ids.size)

        # -- rosters -----------------------------------------------------
        ro = self._bulk(
            "roster", ("api_id", "match_api_id"), ("winner",)
        )
        r_mid, r_ok = _join(m_ids, ro["match_api_id"])
        if not r_ok.all():
            logger.warning(
                "load_stream: dropped %d rosters with missing matches",
                int((~r_ok).sum()),
            )
        r_ids = ro["api_id"][r_ok]
        r_mid = r_mid[r_ok]
        r_win = ro["winner"][r_ok]
        del ro
        team = _cumcount(r_mid, minlength=n)  # arrival order within match
        roster_count = np.bincount(r_mid, minlength=n)
        bad = roster_count != 2  # rater.py:91-93 validity gate

        # Winner flags: exactly one winning roster per match; ties (0 or
        # 2 winners) are non-ratable here (the service path stays strict).
        wflag = np.zeros((n, 2), bool)
        in_team = team < 2
        wflag[r_mid[in_team], team[in_team]] = r_win[in_team] != 0
        tie_m = ~bad & (wflag[:, 0] == wflag[:, 1])
        winner = np.where(wflag[:, 0], 0, 1).astype(np.int32)

        # -- participants ------------------------------------------------
        pa = self._bulk(
            "participant", ("roster_api_id", "player_api_id"), ("went_afk",)
        )
        pr, ok_r = _join(r_ids, pa["roster_api_id"])
        prow, ok_p = _join(p_ids, pa["player_api_id"])
        ok = ok_r & ok_p
        if not ok.all():
            logger.warning(
                "load_stream: dropped %d participants with dangling "
                "roster/player references", int((~ok).sum()),
            )
        midx_p = r_mid[pr[ok]]
        team_p = team[pr[ok]]
        pidx_p = prow[ok]
        afk_p = pa["went_afk"][ok]
        del pa
        # Slot = arrival order within (match, team). The stride must
        # exceed the LARGEST team index present — a malformed match with
        # a third roster would otherwise collide its team-2 key with the
        # next match's team-0 key and corrupt a well-formed neighbor's
        # slot numbering.
        stride = int(team_p.max()) + 1 if team_p.size else 1
        slot = _cumcount(midx_p * stride + team_p, minlength=n * stride)

        player_idx = np.full((n, 2, MAX_TEAM_SIZE), -1, np.int32)
        fits = (team_p < 2) & (slot < MAX_TEAM_SIZE)
        overflow = np.zeros(n, bool)
        if not fits.all():  # team/slot overflow -> non-ratable, not fatal
            overflow[midx_p[~fits]] = True
        player_idx[midx_p[fits], team_p[fits], slot[fits]] = pidx_p[fits]
        afk = np.zeros(n, bool)
        afk[midx_p[afk_p == 1]] = True

        if (overflow | tie_m).any():
            logger.warning(
                "load_stream: %d malformed matches marked non-ratable "
                "(%d team/slot overflow, %d winner-flag ties)",
                int((overflow | tie_m).sum()), int(overflow.sum()),
                int(tie_m.sum()),
            )
        afk |= bad | overflow | tie_m  # encode.py's anyafk |= bad semantics

        stream = MatchStream(
            player_idx=player_idx, winner=winner, mode_id=mode_id, afk=afk
        )

        # -- player state: NULL stays NaN ('nan' fill in the bulk scan) --
        table = np.full((p + 1, TABLE_WIDTH), np.nan, np.float32)
        rrk = np.full(p + 1, np.nan, np.float32)
        rbl = np.full(p + 1, np.nan, np.float32)
        tier = np.zeros(p + 1, np.int32)
        if "rank_points_ranked" in pl:
            rrk[:p] = pl["rank_points_ranked"].astype(np.float32)
        if "rank_points_blitz" in pl:
            rbl[:p] = pl["rank_points_blitz"].astype(np.float32)
        if "skill_tier" in pl:
            tier[:p] = np.clip(
                pl["skill_tier"],
                constants.MIN_SKILL_TIER, constants.MAX_SKILL_TIER,
            ).astype(np.int32)
        for c, base in enumerate(RATING_COLUMNS):
            for col, lo_ in ((f"{base}_mu", MU_LO), (f"{base}_sigma", SIGMA_LO)):
                if col in pl:
                    table[:p, lo_ + c] = pl[col].astype(np.float32)
        del pl
        seed_mu, seed_sigma = trueskill_seed_host(rrk, rbl, tier, cfg)
        table[:, COL_SEED_MU] = seed_mu
        table[:, COL_SEED_SIGMA] = seed_sigma
        state = PlayerState.from_numpy(
            table, rrk, rbl, tier, seed_cfg=cfg, device=device
        )

        cur.close()
        self.conn.rollback()  # release the read snapshot (see asset_urls)
        return ColumnarHistory(
            stream=stream, state=state,
            match_ids=_decode_list(m_ids),
            player_ids=_decode_list(p_ids),
        )

    def write_players(self, state, player_ids: list) -> int:
        """Bulk write-back of the final rating table to the ``player``
        table (the persistence step of a ``rate --db`` full re-rate; the
        service path's per-batch ``commit`` is unchanged). Only rows with
        at least one rating are updated; columns the live schema lacks
        are dropped exactly like :meth:`commit`. Returns rows updated."""
        import numpy as np

        from analyzer_tpu_torch.core.state import MU_LO, SIGMA_LO

        cols = self._rating_cols["player"]
        if not cols:
            return 0
        tbl = state.table[: len(player_ids)].detach().cpu().numpy()
        col_of = {name: i for i, name in enumerate(RATING_COLUMNS)}
        slices = [
            (MU_LO if c.endswith("_mu") else SIGMA_LO)
            + col_of[c.rsplit("_", 1)[0]]
            for c in cols
        ]
        rated = ~np.isnan(tbl[:, MU_LO])  # shared mu set => player touched
        idxs = np.flatnonzero(rated)
        if idxs.size == 0:
            return 0
        # Row building is vectorized: the per-element float()/isnan python
        # loop cost ~4 s at 333k players. float64 (a Python-float subclass
        # the DB-API binds natively; float32 is not) -> object array with
        # NaN -> None, ids appended as the last parameter column.
        vals = tbl[np.ix_(idxs, slices)].astype(np.float64)
        obj = vals.astype(object)
        obj[np.isnan(vals)] = None
        ids = np.array(player_ids, dtype=object)[idxs]
        rows = np.concatenate([obj, ids[:, None]], axis=1).tolist()
        mark = "?" if self._paramstyle == "qmark" else "%s"
        sql = (
            f"UPDATE {self._q('player')} SET "
            + ", ".join(f"{self._q(c)} = {mark}" for c in cols)
            + f" WHERE {self._q('api_id')} = {mark}"
        )
        try:
            cur = self.conn.cursor()
            cur.executemany(sql, rows)
            cur.close()
            self.conn.commit()
        except Exception:
            self.conn.rollback()
            raise
        return len(rows)

    def asset_urls(self, match_api_id: str) -> list[str]:
        rows = self._select_in("asset", ("url",), "match_api_id", [match_api_id])
        # Release the read snapshot the SELECT opened — the reference uses a
        # throwaway autocommit session here (worker.py:124-126); on MySQL a
        # lingering REPEATABLE READ snapshot would hide newly ingested rows
        # from the next load_batch. Never reached with writes pending: the
        # worker commits before fan-out. No-op on sqlite.
        self.conn.rollback()
        return [r[0] for r in rows]

    # -- transaction ------------------------------------------------------
    def commit(self, matches: list) -> None:
        """Flushes the batch graph's rating columns in one transaction
        (the reference's single ``db.commit()`` with rollback-and-reraise,
        ``worker.py:194-199``)."""
        try:
            cur = self.conn.cursor()
            mark = "?" if self._paramstyle == "qmark" else "%s"

            def update(table: str, cols: list[str], key: str, objs: list):
                # Filter against the live schema FIRST, then build rows —
                # columns the deployed schema lacks are dropped, exactly as
                # automap never flushes a non-column attribute.
                cols = [c for c in cols if c in self.columns[table]]
                if not objs or not cols:
                    return
                sql = (
                    f"UPDATE {self._q(table)} SET "
                    + ", ".join(f"{self._q(c)} = {mark}" for c in cols)
                    + f" WHERE {self._q(key)} = {mark}"
                )
                rows = [
                    tuple(getattr(o, c, None) for c in cols) + (getattr(o, key),)
                    for o in objs
                ]
                cur.executemany(sql, rows)

            parts = [p for m in matches for p in m.participants]
            players = {p.player[0].api_id: p.player[0] for p in parts}
            items = [it for p in parts for it in p.participant_items]

            update("match", ["trueskill_quality"], "api_id", matches)
            update("participant",
                   ["trueskill_mu", "trueskill_sigma", "trueskill_delta"],
                   "api_id", parts)
            update("player", self._rating_cols["player"], "api_id",
                   list(players.values()))
            update("participant_items",
                   ["any_afk"] + self._rating_cols["participant_items"],
                   "api_id", items)
            cur.close()
            self.conn.commit()
        except Exception:
            self.conn.rollback()
            raise

    def rollback(self) -> None:
        self.conn.rollback()

    def close(self) -> None:
        self.conn.close()
