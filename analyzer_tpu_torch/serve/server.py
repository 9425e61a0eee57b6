"""ratesrv HTTP endpoints: the query-serving plane's front door.

Rides the shared :mod:`analyzer_tpu_torch.obs.httpd` plumbing (route table on
a daemon ``ThreadingHTTPServer``); each handler thread issues a blocking
engine call, so CONCURRENT requests coalesce into the engine's per-tick
microbatches — the HTTP layer is exactly as wide as the engine is
batched. Binds localhost by default. Counterpart of
``analyzer_tpu.serve.server``: same routes, status codes and bodies.

  ``GET /v1/ratings?ids=a,b,c``       per-player shared rating + seeds;
                                      unknown ids are reported, not 404s;
  ``GET /v1/leaderboard?k=10``        top-k by conservative estimate;
  ``GET /v1/winprob?a=x,y&b=u,v``     P(team a wins) + match quality
                                      (404 when a named id is unknown);
  ``GET /v1/tiers[?score=S]``         conservative-score tier histogram,
                                      plus S's percentile when given;
  ``GET /healthz``                    liveness.

Every response carries ``version`` — the single published view it was
computed against (``docs/serving.md`` on the consistency model). A 503
with ``no ratings view published yet`` means the rater has not committed
a batch since this process started.
"""

from __future__ import annotations

from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs.httpd import (
    DEFAULT_HOST,
    HttpError,
    RoutedHTTPServer,
    json_body,
    text_body,
)
from analyzer_tpu_torch.serve.engine import ServePlane, UnknownPlayerError

logger = get_logger(__name__)

#: Leaderboard depth an HTTP caller may request (the engine's bucket
#: ladder caps at the table size anyway; this bounds response bytes).
MAX_LEADERBOARD_K = 10_000


def _ids_param(params: dict, key: str, limit: int) -> list[str]:
    raw = params.get(key, "").strip()
    ids = [x for x in (part.strip() for part in raw.split(",")) if x]
    if not ids:
        raise HttpError(400, f"query param {key!r} wants comma-separated ids")
    if len(ids) > limit:
        raise HttpError(400, f"too many ids in {key!r} (max {limit})")
    return ids


class ServeServer:
    """The ratesrv thread: routes ``/v1/*`` onto a :class:`ServePlane`.

    ``engine`` is anything satisfying the ServePlane protocol — here the
    single-device :class:`~analyzer_tpu_torch.serve.engine.QueryEngine`;
    the HTTP layer is topology-blind. ``port=0`` binds an ephemeral port
    (tests); the bound port is readable at :attr:`port`. The caller owns
    the engine's lifecycle — ``cli serve`` starts the engine's tick
    thread before the server and closes both on shutdown."""

    def __init__(
        self,
        engine: ServePlane,
        port: int = 0,
        host: str = DEFAULT_HOST,
    ) -> None:
        self.engine = engine
        self._httpd = RoutedHTTPServer(
            routes={
                "/healthz": lambda params: text_body("ok\n"),
                "/v1/ratings": self._route_ratings,
                "/v1/leaderboard": self._route_leaderboard,
                "/v1/winprob": self._route_winprob,
                "/v1/tiers": self._route_tiers,
            },
            port=port,
            host=host,
            name="analyzer-ratesrv",
            json_errors=True,
        )
        self.host = host
        logger.info("ratesrv listening on %s", self.url)

    @property
    def port(self) -> int:
        return self._httpd.port

    @property
    def url(self) -> str:
        return self._httpd.url

    def close(self) -> None:
        """Stops serving and joins the thread. Idempotent; the engine is
        closed by its owner, not here."""
        self._httpd.close()
        logger.info("ratesrv stopped")

    # -- routes -----------------------------------------------------------
    def _engine_call(self, fn, *args):
        try:
            return fn(*args)
        except UnknownPlayerError as err:
            raise HttpError(404, str(err)) from err
        except ValueError as err:
            raise HttpError(400, str(err)) from err
        except RuntimeError as err:
            # "no ratings view published yet" / engine closed — the
            # plane is up but cannot answer; 503 tells a balancer so.
            raise HttpError(503, str(err)) from err

    def _route_ratings(self, params):
        ids = _ids_param(params, "ids", self.engine.max_batch)
        return json_body(self._engine_call(self.engine.get_ratings, ids))

    def _route_leaderboard(self, params):
        raw = params.get("k", "10")
        try:
            k = int(raw)
        except ValueError as err:
            raise HttpError(400, f"k must be an integer, got {raw!r}") from err
        if not 1 <= k <= MAX_LEADERBOARD_K:
            raise HttpError(400, f"k must be in 1..{MAX_LEADERBOARD_K}")
        return json_body(self._engine_call(self.engine.leaderboard, k))

    def _route_winprob(self, params):
        a = _ids_param(params, "a", MAX_TEAM_SIZE)
        b = _ids_param(params, "b", MAX_TEAM_SIZE)
        return json_body(self._engine_call(self.engine.win_probability, a, b))

    def _route_tiers(self, params):
        out = self._engine_call(self.engine.tier_histogram)
        raw = params.get("score")
        if raw is not None:
            try:
                score = float(raw)
            except ValueError as err:
                raise HttpError(
                    400, f"score must be a number, got {raw!r}"
                ) from err
            pct = self._engine_call(self.engine.percentile, score)
            out = {**out, "percentile": pct["percentile"],
                   "score": pct["score"], "below": pct["below"]}
        return json_body(out)
