"""The production-scale serve front door: a concurrent socket plane.

The port's copy of ``analyzer_tpu.serve.frontdoor``: the same routes,
statuses and bytes as the port's stdlib ``ServeServer``.

:class:`~analyzer_tpu_torch.serve.server.ServeServer` rides the stdlib
``ThreadingHTTPServer`` — one OS thread per connection and a
``json.dumps`` walk per response. Fine for obsd scrape rates; hopeless for ROADMAP's
"millions of users". This module is the replacement edge for the hot
``/v1/*`` read path:

  * **persistent connections** — HTTP/1.1 keep-alive with pipelined
    request framing: a client may write N requests back-to-back and
    read N responses, IN ORDER, off one socket;
  * **a small reader pool** — each reader thread runs a ``selectors``
    event loop over its share of the connections (every reader also
    polls the shared listening socket, so accepts spread without a
    dispatcher). Readers never block on the engine: a parsed request is
    submitted to the engine's existing submit/tick microbatcher (which
    is already the correct backpressure surface) and the returned
    pending handle is queued per-connection; responses are written
    strictly in request order as the head handle resolves, so
    pipelining cannot tear or reorder;
  * **native response encoding** — each reader owns a
    :class:`~analyzer_tpu_torch.serve.fastjson.ResponseCodec`: hot responses
    render straight from numpy slabs into a reusable arena,
    byte-identical to the python encoder (differential-pinned), with
    any unrecognized shape falling back, counted.

Route semantics are exactly ``ServeServer``'s (same param validation,
same error mapping to 400/404/503, same JSON error bodies); the
RoutedHTTPServer plane stays for the low-rate obsd endpoints.

:class:`FollowerGroup` is follower mode: N read replicas — each a
fabric :class:`~analyzer_tpu_torch.fabric.route.FollowerPlane` adopting the
leader's published views BY REFERENCE (zero copy, zero re-keying) —
each behind its own :class:`FrontDoor`, with one refresher thread
polling adoption on a fixed cadence. Staleness is bounded by
``refresh_interval_s`` plus the leader's publish throttle, and
:meth:`FollowerGroup.versions` is the per-replica versions vector an
operator compares against the leader (docs/serving.md "Front door").

Clock discipline: this module never reads a wall clock — latency stamps
live in the engine's pending handles (caller-injected clock), and the
loops pace on selector/Event timeouts only. Nor does it call
``json.dumps`` on a hot path: the ONE cold-path exception is
:func:`_error_body` (designated helper — error bodies are not worth a
native shape).
"""

from __future__ import annotations

import json
import selectors
import socket
import threading
import urllib.parse
from collections import deque

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE
from analyzer_tpu_torch.fabric.route import FollowerPlane
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.obs.httpd import DEFAULT_HOST, HttpError
from analyzer_tpu_torch.serve.engine import UnknownPlayerError
from analyzer_tpu_torch.serve.fastjson import ResponseCodec
from analyzer_tpu_torch.serve.server import MAX_LEADERBOARD_K, _ids_param

logger = get_logger(__name__)

#: Header-block cap per request: a connection that exceeds it without
#: completing a request is answered 431 and closed.
MAX_REQUEST_BYTES = 32_768
#: Pipelining depth per connection: beyond this, parsing pauses (bytes
#: stay buffered) until responses drain — backpressure, not an error.
MAX_INFLIGHT_PER_CONN = 256

# Select timeouts: short while any connection has work in flight (the
# engine tick is ~1ms, so resolution polls ride just under it), long
# when idle. Timeouts pace the loop; they are not wall-clock reads.
_BUSY_SELECT_S = 0.0005
_IDLE_SELECT_S = 0.05

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}


def _error_body(message: str) -> bytes:
    # The designated helper: the one json.dumps in the front door.
    # Error bodies match RoutedHTTPServer's json_errors rendering.
    return (json.dumps({"error": message}, sort_keys=True) + "\n").encode(
        "utf-8"
    )


def _head(status: int, length: int, ctype: str, close: bool) -> bytes:
    return (
        f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
        f"Content-Type: {ctype}; charset=utf-8\r\n"
        f"Content-Length: {length}\r\n"
        f"Connection: {'close' if close else 'keep-alive'}\r\n"
        "\r\n"
    ).encode("latin-1")


class _Job:
    """One pipelined request's slot in a connection's response queue.

    ``ready`` is the rendered ``(status, body, ctype)`` (immediate for
    /healthz and parse errors); until then ``pendings`` holds the
    engine handles this response waits on (two for tiers?score=).
    ``close_after`` marks the last response on this connection."""

    __slots__ = ("kind", "pendings", "ready", "close_after")

    def __init__(self, kind, pendings=(), ready=None, close_after=False):
        self.kind = kind
        self.pendings = pendings
        self.ready = ready
        self.close_after = close_after


class _Conn:
    __slots__ = (
        "sock", "rbuf", "wbuf", "inflight", "closing", "eof", "dead",
    )

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.inflight: deque[_Job] = deque()
        self.closing = False  # responses drain, then close
        self.eof = False      # peer half-closed; finish, then close
        self.dead = False     # remove from the loop now


class FrontDoor:
    """The concurrent ``/v1/*`` socket plane over one ServePlane.

    ``engine`` is anything satisfying the ServePlane submit surface —
    the single-device QueryEngine, the sharded engine, or a follower's
    — with its tick thread already started (``Worker(serve_port=)`` /
    ``cli serve`` ownership rules apply unchanged). ``port=0`` binds
    ephemeral; ``readers`` sizes the event-loop pool (each reader owns
    its accepted connections exclusively, so the loops share nothing
    but the listening socket and the engine queue)."""

    def __init__(
        self,
        engine,
        port: int = 0,
        host: str = DEFAULT_HOST,
        readers: int = 4,
        backlog: int = 512,
    ) -> None:
        self.engine = engine
        self.host = host
        self._listen = socket.create_server((host, port), backlog=backlog)
        self._listen.setblocking(False)
        self._port = self._listen.getsockname()[1]
        self._stop = False
        self._nconn = 0
        self._nconn_lock = threading.Lock()
        self.codecs: list[ResponseCodec] = [
            ResponseCodec() for _ in range(max(1, int(readers)))
        ]
        self._threads = [
            threading.Thread(
                target=self._reader_loop, args=(i,), daemon=True,
                name=f"analyzer-frontdoor-{i}",
            )
            for i in range(len(self.codecs))
        ]
        for t in self._threads:
            t.start()
        logger.info("frontdoor listening on %s (%d readers)",
                    self.url, len(self._threads))

    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self._port}"

    def codec_stats(self) -> dict:
        """Aggregate codec route accounting across readers — the serve
        bench's ``native`` flag reads exactly this."""
        encodes = sum(c.encodes for c in self.codecs)
        fallbacks = sum(c.fallbacks for c in self.codecs)
        return {
            "native": bool(
                all(c.native for c in self.codecs) and fallbacks == 0
            ),
            "encodes": encodes,
            "fallbacks": fallbacks,
        }

    def close(self) -> None:
        """Stops the readers and closes every connection. Idempotent;
        the engine is closed by its owner, not here."""
        if self._stop:
            return
        self._stop = True
        for t in self._threads:
            t.join(timeout=5)
        try:
            self._listen.close()
        except OSError:
            pass
        logger.info("frontdoor stopped")

    # -- connection bookkeeping -------------------------------------------
    def _track(self, delta: int) -> None:
        with self._nconn_lock:
            self._nconn += delta
            n = self._nconn
        get_registry().gauge("frontdoor.connections").set(n)

    # -- the reader event loop --------------------------------------------
    def _reader_loop(self, idx: int) -> None:
        codec = self.codecs[idx]
        sel = selectors.DefaultSelector()
        sel.register(self._listen, selectors.EVENT_READ, None)
        conns: dict[int, _Conn] = {}
        try:
            while not self._stop:
                busy = any(
                    c.inflight or c.wbuf or c.rbuf for c in conns.values()
                )
                events = sel.select(_BUSY_SELECT_S if busy
                                    else _IDLE_SELECT_S)
                for key, mask in events:
                    if key.data is None:
                        self._accept(sel, conns)
                    elif mask & selectors.EVENT_READ:
                        self._readable(key.data, codec)
                for conn in conns.values():
                    self._pump(conn, codec)
                for conn in [c for c in conns.values() if c.dead]:
                    self._drop_conn(sel, conns, conn)
        except Exception:  # noqa: BLE001 — a reader must die loudly in
            # the log, not silently strand its share of the sockets.
            logger.exception("frontdoor reader %d crashed", idx)
        finally:
            for conn in list(conns.values()):
                self._drop_conn(sel, conns, conn)
            sel.close()

    def _accept(self, sel, conns) -> None:
        while True:
            try:
                sock, _addr = self._listen.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock)
            conns[sock.fileno()] = conn
            sel.register(sock, selectors.EVENT_READ, conn)
            self._track(+1)

    def _drop_conn(self, sel, conns, conn) -> None:
        fd = conn.sock.fileno()
        try:
            sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        conns.pop(fd, None)
        try:
            conn.sock.close()
        except OSError:
            pass
        self._track(-1)

    def _readable(self, conn: _Conn, codec: ResponseCodec) -> None:
        try:
            while True:
                chunk = conn.sock.recv(65536)
                if not chunk:
                    conn.eof = True
                    break
                conn.rbuf += chunk
                if len(chunk) < 65536:
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            conn.dead = True
            return
        self._parse(conn, codec)

    # -- request framing ---------------------------------------------------
    def _parse(self, conn: _Conn, codec: ResponseCodec) -> None:
        while not conn.closing:
            if len(conn.inflight) >= MAX_INFLIGHT_PER_CONN:
                return  # backpressure: resume once responses drain
            end = conn.rbuf.find(b"\r\n\r\n")
            if end < 0:
                if len(conn.rbuf) > MAX_REQUEST_BYTES:
                    self._reject(conn, 431, "request header block too large")
                return
            if end > MAX_REQUEST_BYTES:
                # Oversized even though terminated — the cap bounds the
                # request, not just the buffer.
                self._reject(conn, 431, "request header block too large")
                return
            head = bytes(conn.rbuf[:end])
            del conn.rbuf[:end + 4]
            self._one_request(conn, head, codec)

    def _reject(self, conn: _Conn, status: int, message: str) -> None:
        """A protocol-level failure: answer ``status`` and close — a
        framing we couldn't parse leaves the byte stream unsafe to
        resync, so the connection cannot be kept."""
        conn.inflight.append(_Job(
            "error",
            ready=(status, _error_body(message), "application/json"),
            close_after=True,
        ))
        conn.closing = True
        conn.rbuf.clear()

    def _one_request(self, conn: _Conn, head: bytes, codec) -> None:
        lines = head.split(b"\r\n")
        try:
            method, target, version = (
                lines[0].decode("latin-1").split(" ", 2)
            )
        except ValueError:
            self._reject(conn, 400, "malformed request line")
            return
        if version not in ("HTTP/1.1", "HTTP/1.0"):
            self._reject(conn, 400, f"unsupported protocol {version!r}")
            return
        headers = {}
        for raw in lines[1:]:
            name, sep, value = raw.partition(b":")
            if not sep:
                self._reject(conn, 400, "malformed header line")
                return
            headers[name.strip().lower()] = value.strip()
        if headers.get(b"transfer-encoding"):
            self._reject(conn, 400, "request bodies are not accepted")
            return
        length = headers.get(b"content-length", b"0")
        try:
            has_body = int(length) > 0
        except ValueError:
            has_body = True
        if has_body:
            self._reject(conn, 400, "request bodies are not accepted")
            return
        conn_hdr = headers.get(b"connection", b"").lower()
        close_after = (
            conn_hdr == b"close"
            or (version == "HTTP/1.0" and conn_hdr != b"keep-alive")
        )
        if method != "GET":
            conn.inflight.append(_Job(
                "error",
                ready=(405, _error_body(f"method {method} not allowed"),
                       "application/json"),
                close_after=close_after,
            ))
        else:
            job = self._route(target)
            job.close_after = close_after
            conn.inflight.append(job)
        if close_after:
            conn.closing = True
            conn.rbuf.clear()

    # -- routing (ServeServer semantics, submit instead of block) ----------
    def _route(self, target: str) -> _Job:
        try:
            parsed = urllib.parse.urlsplit(target)
            params = {
                k: v[-1]
                for k, v in urllib.parse.parse_qs(parsed.query).items()
            }
            path = parsed.path
            if path == "/healthz":
                return _Job("health", ready=(200, b"ok\n", "text/plain"))
            if path == "/v1/ratings":
                ids = _ids_param(params, "ids", self.engine.max_batch)
                return _Job("ratings", pendings=(
                    self.engine.submit("ratings", tuple(ids)),
                ))
            if path == "/v1/leaderboard":
                raw = params.get("k", "10")
                try:
                    k = int(raw)
                except ValueError as err:
                    raise HttpError(
                        400, f"k must be an integer, got {raw!r}"
                    ) from err
                if not 1 <= k <= MAX_LEADERBOARD_K:
                    raise HttpError(400, f"k must be in 1..{MAX_LEADERBOARD_K}")
                return _Job("leaderboard", pendings=(
                    self.engine.submit("leaderboard", k),
                ))
            if path == "/v1/winprob":
                a = _ids_param(params, "a", MAX_TEAM_SIZE)
                b = _ids_param(params, "b", MAX_TEAM_SIZE)
                return _Job("winprob", pendings=(
                    self.engine.submit("winprob", (tuple(a), tuple(b))),
                ))
            if path == "/v1/tiers":
                raw = params.get("score")
                if raw is None:
                    return _Job("tiers", pendings=(
                        self.engine.submit("tiers"),
                    ))
                try:
                    score = float(raw)
                except ValueError as err:
                    raise HttpError(
                        400, f"score must be a number, got {raw!r}"
                    ) from err
                return _Job("tiers", pendings=(
                    self.engine.submit("tiers"),
                    self.engine.submit("percentile", score),
                ))
            raise HttpError(404, "not found")
        except HttpError as err:
            return _Job("error", ready=(
                err.status, _error_body(err.message), "application/json"
            ))
        except Exception:  # noqa: BLE001 — same crash guard as the
            # routed server: a broken route answers 500, the loop lives.
            logger.exception("frontdoor route failed for %s", target)
            return _Job("error", ready=(
                500, _error_body("internal error"), "application/json"
            ))

    # -- response pumping --------------------------------------------------
    def _finish(self, job: _Job, codec: ResponseCodec):
        for p in job.pendings:
            if p.error is not None:
                return self._map_error(p.error)
        value = job.pendings[0].value
        if job.kind == "tiers" and len(job.pendings) == 2:
            pct = job.pendings[1].value
            value = {**value, "percentile": pct["percentile"],
                     "score": pct["score"], "below": pct["below"]}
        return 200, codec.encode(job.kind, value), "application/json"

    def _map_error(self, err: BaseException):
        if isinstance(err, UnknownPlayerError):
            return 404, _error_body(str(err)), "application/json"
        if isinstance(err, ValueError):
            return 400, _error_body(str(err)), "application/json"
        if isinstance(err, RuntimeError):
            # "no ratings view published yet" / engine closed — plane
            # up, cannot answer; 503 tells a balancer so.
            return 503, _error_body(str(err)), "application/json"
        logger.error("frontdoor query failed: %r", err)
        return 500, _error_body("internal error"), "application/json"

    def _pump(self, conn: _Conn, codec: ResponseCodec) -> None:
        if conn.dead:
            return
        if conn.rbuf and not conn.closing:
            self._parse(conn, codec)  # resume deferred pipelined bytes
        q = conn.inflight
        reg = get_registry()
        while q:
            job = q[0]
            if job.ready is None:
                if not all(p.done.is_set() for p in job.pendings):
                    break
                job.ready = self._finish(job, codec)
            status, body, ctype = job.ready
            conn.wbuf += _head(status, len(body), ctype, job.close_after)
            conn.wbuf += body
            reg.counter("frontdoor.requests_total").add(1)
            reg.counter("frontdoor.encode_bytes_total").add(len(body))
            q.popleft()
            if job.close_after:
                break
        self._flush(conn)

    def _flush(self, conn: _Conn) -> None:
        if conn.wbuf:
            try:
                sent = conn.sock.send(conn.wbuf)
                del conn.wbuf[:sent]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                conn.dead = True
                return
        if not conn.wbuf and not conn.inflight and (conn.closing or conn.eof):
            conn.dead = True


class FollowerGroup:
    """N follower read replicas behind their own front doors.

    Each replica is a :class:`~analyzer_tpu_torch.fabric.route.FollowerPlane`
    — a private ViewPublisher adopting the ``leader`` publisher's
    views by reference plus its own QueryEngine — fronted by its own
    :class:`FrontDoor`, so reads scale horizontally without copying or
    re-keying the table (threads stand in for reader processes; the
    adoption mechanism is process-shape-blind). One refresher thread
    polls every replica on an Event cadence: a replica's staleness is
    bounded by ``refresh_interval_s`` plus the leader's publish
    throttle, and :meth:`versions` is the vector an operator compares
    against the leader's version (docs/serving.md)."""

    def __init__(
        self,
        leader,
        cfg: RatingConfig | None = None,
        n_followers: int = 2,
        refresh_interval_s: float = 0.005,
        max_batch: int = 256,
        readers: int = 2,
        host: str = DEFAULT_HOST,
        clock=None,
    ) -> None:
        self.leader = leader
        self.refresh_interval_s = float(refresh_interval_s)
        self.planes = [
            FollowerPlane(leader, cfg=cfg, max_batch=max_batch, clock=clock)
            for _ in range(int(n_followers))
        ]
        self._readers = int(readers)
        self._host = host
        self.doors: list[FrontDoor] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "FollowerGroup":
        if self._thread is not None:
            return self
        for plane in self.planes:
            plane.start()
        self.doors = [
            FrontDoor(plane.engine, readers=self._readers, host=self._host)
            for plane in self.planes
        ]
        self._thread = threading.Thread(
            target=self._refresh_loop, name="analyzer-follower-refresh",
            daemon=True,
        )
        self._thread.start()
        return self

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.refresh_interval_s):
            for plane in self.planes:
                plane.refresh()

    def refresh(self) -> int:
        """One synchronous adoption sweep; returns how many replicas
        advanced (tests drive this for deterministic staleness)."""
        return sum(1 for plane in self.planes if plane.refresh())

    @property
    def versions(self) -> list[int]:
        """Per-replica adopted versions — the bounded-staleness vector."""
        return [plane.version for plane in self.planes]

    @property
    def urls(self) -> list[str]:
        return [door.url for door in self.doors]

    def close(self) -> None:
        thread, self._thread = self._thread, None
        if thread is not None:
            self._stop.set()
            thread.join(timeout=5)
        for door in self.doors:
            door.close()
        for plane in self.planes:
            plane.close()
