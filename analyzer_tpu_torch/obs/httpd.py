"""Shared stdlib HTTP plumbing for the package's listening planes.

The port's own copy of ``analyzer_tpu.obs.httpd`` (stdlib only). ratesrv
(``serve/server.py`` — the query-serving plane) rides it: route dispatch,
query-string parsing, content-type + length headers, the
500-on-renderer-crash guard, the daemon serving thread, the idempotent
close:

  * :class:`RoutedHTTPServer` — a ``ThreadingHTTPServer`` on a daemon
    thread whose GET handler dispatches on the *path* to a route table of
    ``fn(params) -> (status, body, content_type)`` callables (``params``
    is the parsed query string, last-value-wins);
  * :class:`HttpError` — raise from a route to return a clean non-200
    (bad query params, unknown player ids) instead of a 500;
  * :func:`json_body` / :func:`text_body` — response tuple helpers.

Bind policy lives here too: ``DEFAULT_HOST`` is loopback, and widening to
a real interface is an operator's explicit runtime choice — never a code
default.
"""

from __future__ import annotations

import http.client
import io
import json
import threading
import urllib.error
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from analyzer_tpu_torch.logging_utils import get_logger

logger = get_logger(__name__)

#: Loopback by default: both planes carry operational detail and must be
#: opted ONTO a network interface, never discovered on one.
DEFAULT_HOST = "127.0.0.1"


class HttpError(Exception):
    """A route's clean failure: rendered as ``status`` with a one-line
    plain-text (or JSON, for ``/v1/`` routes) body instead of the 500 the
    crash guard would produce."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status
        self.message = message


def json_body(obj, status: int = 200) -> tuple[int, str, str]:
    """A JSON response tuple (sorted keys — curl diffs must be stable)."""
    return status, json.dumps(obj, sort_keys=True) + "\n", "application/json"


def text_body(body: str, status: int = 200) -> tuple[int, str, str]:
    return status, body, "text/plain"


class RoutedHTTPServer:
    """A route-table HTTP server on a daemon thread.

    ``routes`` maps an exact path (``"/healthz"``) to
    ``fn(params: dict[str, str]) -> (status, body, content_type)``.
    ``post_routes`` maps a path to ``fn(body) -> (status, body,
    content_type)`` where ``body`` is the request's parsed JSON (None
    for an empty body). ``port=0`` binds an
    ephemeral port (tests); the bound port is readable at :attr:`port`.
    Stop with :meth:`close` (idempotent) — whoever started the plane
    owns that call.
    """

    def __init__(
        self,
        routes: dict,
        port: int = 0,
        host: str = DEFAULT_HOST,
        name: str = "analyzer-httpd",
        json_errors: bool = False,
        local_only: set | None = None,
        post_routes: dict | None = None,
    ) -> None:
        self._routes = dict(routes)
        self._post_routes = dict(post_routes or {})
        self._json_errors = json_errors
        # Paths that ACT (trigger a dump) rather than read: they answer
        # only to loopback peers even when an operator widened the bind
        # to a real interface — a scraper on the network may look, not
        # touch.
        self._local_only = set(local_only or ())
        server = self

        class Handler(BaseHTTPRequestHandler):
            # The handler closes over the server object, not globals —
            # two planes in one process must not share route tables.

            # Keep-alive: the stdlib default (HTTP/1.0) closes the TCP
            # connection after every response, so every
            # request paid a fresh handshake. Every _send
            # stamps Content-Length, which is all HTTP/1.1 persistence
            # requires.
            protocol_version = "HTTP/1.1"
            # A response is two writes (the headers at end_headers, then
            # the body): with Nagle on, the body waits for the client's
            # delayed ACK of the headers, ~40 ms on a kept-alive
            # connection. TCP_NODELAY sends it at once.
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # quiet: curl spam is DEBUG
                logger.debug("%s: " + fmt, name, *args)

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype + "; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 — http.server contract
                parsed = urllib.parse.urlsplit(self.path)
                path = parsed.path
                fn = server._routes.get(path)
                if fn is None:
                    self._send(*server._error(404, "not found"))
                    return
                if path in server._local_only and (
                    self.client_address[0] not in ("127.0.0.1", "::1")
                ):
                    self._send(*server._error(
                        403, "localhost-only endpoint"
                    ))
                    return
                params = {
                    k: v[-1]
                    for k, v in urllib.parse.parse_qs(parsed.query).items()
                }
                try:
                    self._send(*fn(params))
                except HttpError as err:
                    self._send(*server._error(err.status, err.message))
                except Exception:  # noqa: BLE001 — a broken route must
                    # surface as a 500 response, not kill the serving
                    # thread the other routes still need.
                    logger.exception("%s route failed for %s", name, path)
                    self._send(*server._error(500, "internal error"))

            def do_POST(self):  # noqa: N802 — http.server contract
                parsed = urllib.parse.urlsplit(self.path)
                path = parsed.path
                fn = server._post_routes.get(path)
                if fn is None:
                    self._send(*server._error(404, "not found"))
                    return
                if path in server._local_only and (
                    self.client_address[0] not in ("127.0.0.1", "::1")
                ):
                    self._send(*server._error(
                        403, "localhost-only endpoint"
                    ))
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length) if length else b""
                    body = json.loads(raw) if raw else None
                except (ValueError, UnicodeDecodeError):
                    self._send(*server._error(400, "body must be JSON"))
                    return
                try:
                    self._send(*fn(body))
                except HttpError as err:
                    self._send(*server._error(err.status, err.message))
                except Exception:  # noqa: BLE001 — same crash guard as GET
                    logger.exception("%s POST route failed for %s", name, path)
                    self._send(*server._error(500, "internal error"))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=name, daemon=True
        )
        self._thread.start()

    def _error(self, status: int, message: str) -> tuple[int, str, str]:
        if self._json_errors:
            return json_body({"error": message}, status)
        return text_body(message + "\n", status)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        """Stops serving and joins the thread. Idempotent."""
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        self._thread.join(timeout=5)


class PooledHTTPClient:
    """One persistent keep-alive connection to a single ``host:port``.

    The client side of :attr:`Handler.protocol_version` = HTTP/1.1: a
    ``urlopen`` per call pays a fresh TCP handshake per lookup, by
    far the dominant cost of a small GET. This pool holds ONE
    ``http.client.HTTPConnection`` and reuses it across requests
    (``frontdoor.pool_reuse_total`` counts the saved handshakes;
    :attr:`reuse_count` is the per-pool view the tests assert on).

    urlopen-compatible failure surface: a non-2xx status raises
    :class:`urllib.error.HTTPError` (body readable), a transport
    failure raises :class:`urllib.error.URLError` (an ``OSError``). A
    request that dies on a PREVIOUSLY-USED connection is retried once
    on a fresh one — the server idle-closing between requests is the
    one legal keep-alive race; a fresh-connection failure is real and
    propagates. Thread-safe: one in-flight request at a time (lock);
    callers that want parallelism hold one pool per thread or accept
    the serialization.
    """

    def __init__(self, base_url: str, timeout_s: float = 30.0) -> None:
        parsed = urllib.parse.urlsplit(base_url)
        if parsed.scheme not in ("http", ""):
            raise ValueError(f"PooledHTTPClient is http-only: {base_url!r}")
        self.base_url = base_url.rstrip("/")
        self.host = parsed.hostname or DEFAULT_HOST
        self.port = parsed.port or 80
        self.timeout_s = float(timeout_s)
        self.reuse_count = 0
        self.requests = 0
        self._conn: http.client.HTTPConnection | None = None
        self._lock = threading.Lock()

    def _drop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def _exchange(self, path_qs: str, fresh: bool) -> bytes:
        conn = self._conn
        conn.request("GET", path_qs)
        resp = conn.getresponse()
        body = resp.read()  # drain fully or the conn can't be reused
        if resp.will_close:
            self._drop()
        if not fresh:
            self.reuse_count += 1
            _registry().counter("frontdoor.pool_reuse_total").add(1)
        if not 200 <= resp.status < 300:
            raise urllib.error.HTTPError(
                self.base_url + path_qs, resp.status, resp.reason,
                resp.headers, io.BytesIO(body),
            )
        return body

    def get(self, path_qs: str) -> bytes:
        """GET ``path_qs`` (path + encoded query) over the pooled
        connection; returns the response body bytes."""
        with self._lock:
            self.requests += 1
            fresh = self._conn is None
            if fresh:
                self._conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout_s
                )
            try:
                return self._exchange(path_qs, fresh)
            except urllib.error.HTTPError:
                raise
            except (http.client.HTTPException, OSError) as err:
                self._drop()
                if fresh:
                    raise urllib.error.URLError(err) from err
                # Stale pooled connection: retry exactly once, fresh.
                self._conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout_s
                )
                try:
                    return self._exchange(path_qs, True)
                except urllib.error.HTTPError:
                    raise
                except (http.client.HTTPException, OSError) as err2:
                    self._drop()
                    raise urllib.error.URLError(err2) from err2

    def close(self) -> None:
        with self._lock:
            self._drop()


def _registry():
    # Lazy: the counter is best-effort telemetry.
    from analyzer_tpu_torch.obs.registry import get_registry

    return get_registry()
