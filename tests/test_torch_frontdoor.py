"""The port's serve front door (``analyzer_tpu_torch.serve.frontdoor``) and
its response codec (``serve/fastjson.py`` over ``serve/csrc/fastjson.cc``,
built with g++ at first use), on the CPU.

  * every status and body the front door serves equals the port's stdlib
    ``ServeServer``'s for the same request on the same engine, byte for
    byte, errors included, with the native codec carrying every hot shape
    (0 fallbacks);
  * keep-alive and pipelining: N requests written back to back on one
    socket answer N responses in request order; 64 pipelined sockets
    against a publisher thread see no torn response and per-connection
    versions that never go back;
  * malformed requests answer 400 / 405 / 431 and the reader loop lives on;
    half-open and mid-request closes do not wedge it;
  * the codec: native bytes equal the python encoder's and
    ``json.dumps(sort_keys=True)``'s, floats equal CPython's ``repr`` over a
    sweep, adversarial shapes fall back (counted) with equal bytes, a
    non-finite float raises; the port's ``ResponseCodec.encode`` equals
    JAX's on the same response dicts;
  * ``FollowerGroup``: every replica serves the leader's bytes at the same
    version, and adopts a new leader version within its refresh bound;
  * the soak with ``serve_http=True`` gives the in-process run's
    deterministic block byte for byte.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest

from analyzer_tpu.serve.fastjson import ResponseCodec as JaxCodec
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import MU_LO, SIGMA_LO, PlayerState
from analyzer_tpu_torch.obs import get_registry, reset_registry
from analyzer_tpu_torch.serve import QueryEngine, ViewPublisher
from analyzer_tpu_torch.serve import _native_json, fastjson
from analyzer_tpu_torch.serve.fastjson import ResponseCodec
from analyzer_tpu_torch.serve.frontdoor import (
    MAX_INFLIGHT_PER_CONN,
    MAX_REQUEST_BYTES,
    FollowerGroup,
    FrontDoor,
)
from analyzer_tpu_torch.serve.server import ServeServer

CFG = RatingConfig()


@pytest.fixture(autouse=True)
def fresh_registry():
    reset_registry()
    yield
    reset_registry()


def rated_table(n_players: int, n_rated: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    state = PlayerState.create(
        n_players, skill_tier=rng.integers(1, 29, n_players), cfg=CFG,
        device="cpu",
    )
    table = state.table.numpy().copy()
    table[:n_rated, MU_LO] = rng.normal(1500, 400, n_rated).astype(np.float32)
    table[:n_rated, SIGMA_LO] = rng.uniform(50, 600, n_rated).astype(np.float32)
    return table[:n_players]


def make_plane(n_players=60, n_rated=45, seed=0, **door_kw):
    pub = ViewPublisher(device="cpu")
    ids = [f"p{i}" for i in range(n_players)]
    pub.publish_rows(ids, rated_table(n_players, n_rated, seed))
    engine = QueryEngine(pub, cfg=CFG, device="cpu").start()
    door = FrontDoor(engine, **door_kw)
    return pub, ids, engine, door


def read_response(sock, buf: bytearray):
    """(status, headers, body) for one Content-Length-framed response."""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("closed mid-head")
        buf += chunk
    end = buf.index(b"\r\n\r\n")
    head = bytes(buf[:end])
    del buf[: end + 4]
    lines = head.split(b"\r\n")
    status = int(lines[0].split(None, 2)[1])
    headers = {}
    for line in lines[1:]:
        name, _, value = line.partition(b":")
        headers[name.strip().lower()] = value.strip()
    clen = int(headers.get(b"content-length", b"0"))
    while len(buf) < clen:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("closed mid-body")
        buf += chunk
    body = bytes(buf[:clen])
    del buf[:clen]
    return status, headers, body


def get_raw(port, target, sock=None, buf=None):
    """One GET over a (possibly reused) raw socket."""
    own = sock is None
    if own:
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        buf = bytearray()
    try:
        sock.sendall(f"GET {target} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
        return read_response(sock, buf)
    finally:
        if own:
            sock.close()


# ---------------------------------------------------------------------------
PARITY_TARGETS = [
    "/healthz",
    "/v1/ratings?ids=p0,p1,p2,p44",
    "/v1/ratings?ids=p50,ghost,p0",        # unrated + unknown mix
    "/v1/ratings?ids=" + ",".join(f"p{i}" for i in range(60)),
    "/v1/leaderboard",                     # default k
    "/v1/leaderboard?k=7",
    "/v1/leaderboard?k=60",
    "/v1/leaderboard?k=0",                 # 400: out of range
    "/v1/leaderboard?k=zebra",             # 400: not an integer
    "/v1/winprob?a=p0,p1&b=p2,p3",
    "/v1/winprob?a=p0,p1,p2,p3,p4&b=p50,p51,p52,p53,p54",
    "/v1/winprob?a=p0&b=ghost",            # 404: unknown player
    "/v1/winprob?a=p0,p1,p2,p3,p4,p5&b=p6",  # 400: too many ids
    "/v1/tiers",
    "/v1/tiers?score=1500.5",
    "/v1/tiers?score=-1e9",
    "/v1/tiers?score=tall",                # 400: not a number
    "/v1/ratings?ids=",                    # 400: empty ids
    "/nope",                               # 404: unrouted
]


class TestServeParity:
    def test_byte_for_byte_with_stdlib_plane(self):
        import http.client

        pub, ids, engine, door = make_plane()
        srv = ServeServer(engine)
        try:
            ref = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
            sock = socket.create_connection(("127.0.0.1", door.port), timeout=10)
            buf = bytearray()
            for target in PARITY_TARGETS:
                ref.request("GET", target)
                resp = ref.getresponse()
                want_status, want_body = resp.status, resp.read()
                got_status, headers, got_body = get_raw(door.port, target, sock, buf)
                assert got_status == want_status, target
                assert got_body == want_body, target
                assert headers[b"connection"] == b"keep-alive"
            ref.close()
            sock.close()
            stats = door.codec_stats()
            assert stats == {"native": True, "encodes": 11, "fallbacks": 0}
            assert get_registry().counter("frontdoor.codec_fallbacks_total").value == 0
        finally:
            srv.close()
            door.close()
            engine.close()

    def test_pipelined_responses_in_request_order(self):
        pub, ids, engine, door = make_plane()
        try:
            targets = ["/v1/leaderboard?k=1", "/v1/ratings?ids=p5", "/healthz",
                       "/v1/tiers", "/v1/winprob?a=p1&b=p2"] * 6
            sock = socket.create_connection(("127.0.0.1", door.port), timeout=10)
            buf = bytearray()
            try:
                sock.sendall(b"".join(
                    f"GET {t} HTTP/1.1\r\nHost: t\r\n\r\n".encode() for t in targets))
                for target in targets:
                    status, _, body = read_response(sock, buf)
                    assert status == 200
                    if target == "/healthz":
                        assert body == b"ok\n"
                    elif "leaderboard" in target:
                        assert len(json.loads(body)["leaders"]) == 1
                    elif "ratings" in target:
                        assert json.loads(body)["ratings"][0]["id"] == "p5"
                    elif "winprob" in target:
                        assert 0.0 <= json.loads(body)["p_a"] <= 1.0
                    else:
                        assert "edges" in json.loads(body)
                # Connection: close on the last request ends the socket.
                sock.sendall(b"GET /healthz HTTP/1.1\r\nConnection: close\r\n\r\n")
                status, headers, body = read_response(sock, buf)
                assert (status, body, headers[b"connection"]) == (200, b"ok\n", b"close")
                assert sock.recv(10) == b""
            finally:
                sock.close()
            assert MAX_INFLIGHT_PER_CONN == 256 and MAX_REQUEST_BYTES == 32_768
        finally:
            door.close()
            engine.close()


# ---------------------------------------------------------------------------
MALFORMED = [
    (b"GARBAGE\r\n\r\n", 400),
    (b"GET /healthz HTTP/2.0\r\nHost: t\r\n\r\n", 400),
    (b"GET /healthz\r\n\r\n", 400),
    (b"GET /healthz HTTP/1.1\r\nno-colon-here\r\n\r\n", 400),
    (b"POST /v1/ratings?ids=p0 HTTP/1.1\r\nHost: t\r\n\r\n", 405),
    (b"DELETE /healthz HTTP/1.1\r\n\r\n", 405),
    (b"GET /v1/ratings?ids=p0 HTTP/1.1\r\nContent-Length: 5\r\n\r\nhello", 400),
    (b"GET /v1/ratings?ids=p0 HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n", 400),
    (b"GET /" + b"x" * MAX_REQUEST_BYTES + b" HTTP/1.1\r\n\r\n", 431),
    (b"GET /" + b"y" * (MAX_REQUEST_BYTES + 10), 431),   # never terminated
]


class TestMalformed:
    def test_malformed_table_then_still_serving(self):
        pub, ids, engine, door = make_plane()
        try:
            for payload, want in MALFORMED:
                sock = socket.create_connection(("127.0.0.1", door.port), timeout=10)
                try:
                    sock.sendall(payload)
                    status, _, body = read_response(sock, bytearray())
                    assert status == want, payload[:40]
                    assert b"error" in body, payload[:40]
                finally:
                    sock.close()
                status, _, body = get_raw(door.port, "/healthz")
                assert (status, body) == (200, b"ok\n"), payload[:40]
        finally:
            door.close()
            engine.close()

    def test_half_open_and_midstream_close_survive(self):
        pub, ids, engine, door = make_plane()
        try:
            for fragment in (b"GET /v1/rat", b"GET /healthz HTTP/1.1\r\nHo"):
                sock = socket.create_connection(("127.0.0.1", door.port), timeout=10)
                sock.sendall(fragment)
                sock.close()
            # Half-close after a full request: the answer still arrives.
            sock = socket.create_connection(("127.0.0.1", door.port), timeout=10)
            sock.sendall(b"GET /v1/leaderboard?k=2 HTTP/1.1\r\n\r\n")
            sock.shutdown(socket.SHUT_WR)
            status, _, body = read_response(sock, bytearray())
            assert status == 200 and len(json.loads(body)["leaders"]) == 2
            sock.close()
            assert get_raw(door.port, "/healthz")[::2] == (200, b"ok\n")
        finally:
            door.close()
            engine.close()


# ---------------------------------------------------------------------------
class TestPipelinedTorture:
    N_SOCKETS = 64
    REQUESTS_PER_SOCKET = 24

    def _client(self, port, worker, failures, versions):
        targets = [
            ("/v1/leaderboard?k=3", "leaderboard"),
            (f"/v1/ratings?ids=p{worker % 60},p{(worker + 7) % 60}", "ratings"),
            (f"/v1/winprob?a=p{worker % 45}&b=p{(worker + 1) % 45}", "winprob"),
            ("/v1/tiers", "tiers"),
        ]
        seen = []
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=30)
            buf = bytearray()
            try:
                reqs = [targets[i % len(targets)]
                        for i in range(self.REQUESTS_PER_SOCKET)]
                half = len(reqs) // 2
                for burst in (reqs[:half], reqs[half:]):
                    sock.sendall(b"".join(
                        f"GET {t} HTTP/1.1\r\nHost: t\r\n\r\n".encode()
                        for t, _ in burst))
                    for target, kind in burst:
                        status, _, body = read_response(sock, buf)
                        if status != 200:
                            failures.append((worker, target, status))
                            continue
                        obj = json.loads(body)  # torn bytes would raise
                        if kind == "leaderboard" and len(obj["leaders"]) != 3:
                            failures.append((worker, target, "short board"))
                        if kind == "winprob" and not 0.0 <= obj["p_a"] <= 1.0:
                            failures.append((worker, target, obj["p_a"]))
                        seen.append(obj["version"])
            finally:
                sock.close()
        except Exception as err:  # noqa: BLE001 — report, don't hang the join
            failures.append((worker, "transport", repr(err)))
        versions[worker] = seen

    def test_no_torn_responses_and_monotone_versions(self):
        pub, ids, engine, door = make_plane(readers=4)
        stop = threading.Event()
        published = []

        def publisher():
            seed = 1
            while not stop.is_set():
                pub.publish_rows(ids, rated_table(60, 45, seed))
                published.append(pub.version)
                seed += 1
                time.sleep(0.002)

        failures: list = []
        versions: dict = {}
        pub_thread = threading.Thread(target=publisher, daemon=True)
        pub_thread.start()
        try:
            clients = [threading.Thread(target=self._client,
                                        args=(door.port, w, failures, versions),
                                        daemon=True)
                       for w in range(self.N_SOCKETS)]
            for t in clients:
                t.start()
            for t in clients:
                t.join(timeout=60)
                assert not t.is_alive(), "client hung"
        finally:
            stop.set()
            pub_thread.join(timeout=10)
            stats = door.codec_stats()
            door.close()
            engine.close()
        assert failures == []
        assert len(published) >= 2, "publisher barely ran"
        total = sum(len(v) for v in versions.values())
        assert total == self.N_SOCKETS * self.REQUESTS_PER_SOCKET
        for worker, seen in versions.items():
            assert seen == sorted(seen), f"non-monotone on {worker}: {seen}"
        assert any(len(set(v)) > 1 for v in versions.values())
        assert stats["native"] and stats["fallbacks"] == 0
        reg = get_registry()
        assert reg.counter("frontdoor.requests_total").value >= total
        assert reg.counter("frontdoor.encode_bytes_total").value > 0


# ---------------------------------------------------------------------------
def oracle_bytes(obj) -> bytes:
    return (json.dumps(obj, sort_keys=True) + "\n").encode("utf-8")


HOT_SHAPES = [
    ("ratings", {"version": 1, "ratings": [], "unknown": []}),
    ("ratings", {"version": 7, "unknown": ["ghost", "zéro", "\x01\"q\\"], "ratings": [
        {"id": "p0", "rated": True, "mu": 1500.25, "sigma": 71.5,
         "conservative": 1285.75, "seed_mu": 1500.0, "seed_sigma": 400.0},
        {"id": "p☃", "rated": False, "mu": None, "sigma": None,
         "conservative": None, "seed_mu": 1437.5, "seed_sigma": 350.0},
        {"id": "p😀\t", "rated": True, "mu": -0.0, "sigma": 1e-300,
         "conservative": 1e16, "seed_mu": 123456789012345.6, "seed_sigma": 5e-5},
    ]}),
    ("leaderboard", {"version": 3, "leaders": [
        {"rank": 1, "id": "p9", "mu": 1712.0, "sigma": 50.5, "conservative": 1560.5},
        {"rank": 2, "id": "pü", "mu": -0.125, "sigma": 1e-3,
         "conservative": 12345678.90625},
    ]}),
    ("leaderboard", {"version": 3, "leaders": []}),
    ("winprob", {"version": 2, "p_a": 0.7310585786300049,
                 "quality": 0.9999999999999999}),
    ("tiers", {"version": 4, "edges": [1000.0, 1500.0], "counts": [10, 5, 1],
               "rated": 16}),
    ("tiers", {"version": 4, "edges": [1000.0, 1500.0], "counts": [10, 5, 1],
               "rated": 16, "score": 1234.5, "below": 9, "percentile": 56.25}),
    ("tiers", {"version": 4, "edges": [], "counts": [0], "rated": 0,
               "score": 1.5, "below": 0, "percentile": None}),
]

ADVERSARIAL_SHAPES = [
    ("ratings", {"version": 1, "ratings": {"a": 1}, "unknown": []}),
    ("ratings", {"version": 1, "ratings": [
        {"id": "p0", "rated": True, "mu": 1, "sigma": 2.0,
         "conservative": 3.0, "seed_mu": 4.0, "seed_sigma": 5.0}], "unknown": []}),
    ("ratings", {"version": 1, "ratings": [
        {"id": "p0", "rated": 1, "mu": 1.0, "sigma": 2.0,
         "conservative": 3.0, "seed_mu": 4.0, "seed_sigma": 5.0}], "unknown": []}),
    ("ratings", {"version": True, "ratings": [], "unknown": []}),
    ("ratings", {"version": 1, "ratings": [], "unknown": [3]}),
    ("ratings", {"version": 1, "ratings": [{"id": "p0"}], "unknown": []}),
    ("ratings", {"version": 1, "ratings": [
        {"id": "p0", "rated": True, "mu": 1.0, "sigma": 2.0,
         "conservative": 3.0, "seed_mu": 4.0, "seed_sigma": 5.0,
         "extra": 1}], "unknown": []}),
    ("ratings", {"versions": {"0": 1}, "ratings": [], "unknown": []}),  # fabric
    ("leaderboard", {"version": 1, "leaders": [
        {"rank": 1.0, "id": "p0", "mu": 1.0, "sigma": 2.0, "conservative": 3.0}]}),
    ("leaderboard", {"version": 1, "leaders": None}),
    ("winprob", {"version": 1, "p_a": "0.5", "quality": 1.0}),
    ("winprob", {"version": 1, "p_a": 0.5}),
    ("tiers", {"version": 1, "edges": [1.0], "counts": (0,), "rated": 0}),
    ("tiers", {"version": 1, "edges": [1.0], "counts": [0], "rated": 0,
               "score": 1.0}),
    ("health", {"ok": True}),
]


class TestCodec:
    def test_import_builds_nothing_first_codec_builds(self):
        # The library is built at the first codec (in this test process
        # that may be any test's), never by importing the module.
        codec = ResponseCodec()
        assert codec.native and fastjson.native_available()
        assert _native_json._lib is not None

    def test_hot_shapes_native_equal_python_and_dumps(self):
        codec, py = ResponseCodec(), ResponseCodec()
        py.native = False
        for kind, obj in HOT_SHAPES:
            got = codec.encode(kind, obj)
            assert got == oracle_bytes(obj) == py.encode(kind, obj), (kind, obj)
        assert codec.fallbacks == 0 and codec.encodes == len(HOT_SHAPES)
        assert py.fallbacks == len(HOT_SHAPES)  # the python route is counted

    def test_equal_to_jax_codec(self):
        port, jax = ResponseCodec(), JaxCodec()
        for kind, obj in HOT_SHAPES + ADVERSARIAL_SHAPES:
            assert port.encode(kind, obj) == jax.encode(kind, obj), (kind, obj)
        assert (port.encodes, port.fallbacks) == (jax.encodes, jax.fallbacks)

    def test_float_repr_sweep(self):
        rng = np.random.default_rng(20)
        vals = [float(x) for x in rng.normal(0, 1e4, 400)]
        vals += [float(x) for x in rng.uniform(-1, 1, 400)]
        vals += [float(np.float32(x)) for x in rng.normal(1500, 300, 200)]
        vals += [0.0, -0.0, 1e-308, 5e-324, 1.7976931348623157e308, 0.1,
                 2.0 / 3.0, 1e16, 1e-4, 1e-5, 123456789012345678.0]
        codec = ResponseCodec()
        for i in range(0, len(vals), 8):
            chunk = vals[i:i + 8]
            obj = {"version": 1, "p_a": chunk[0], "quality": sum(chunk) or 0.5}
            assert codec.encode("winprob", obj) == oracle_bytes(obj)
            obj = {"version": 2, "edges": chunk, "counts": [1] * 9, "rated": 9}
            assert codec.encode("tiers", obj) == oracle_bytes(obj)
        assert codec.fallbacks == 0

    def test_native_repr_double_matches_cpython(self):
        rng = np.random.default_rng(21)
        vals = [float(x) for x in rng.normal(0, 1, 500)]
        vals += [float(x) for x in 10.0 ** rng.uniform(-300, 300, 500)]
        vals += [float(np.float32(x)) for x in rng.normal(0, 1e3, 500)]
        for v in vals:
            assert _native_json.repr_double(v).decode() == repr(v), v
        with pytest.raises(ValueError):
            _native_json.repr_double(float("nan"))

    def test_adversarial_shapes_fall_back_byte_identical(self):
        codec = ResponseCodec()
        for kind, obj in ADVERSARIAL_SHAPES:
            assert codec.encode(kind, obj) == oracle_bytes(obj), (kind, obj)
        assert codec.fallbacks == len(ADVERSARIAL_SHAPES)
        assert get_registry().counter(
            "frontdoor.codec_fallbacks_total").value == len(ADVERSARIAL_SHAPES)

    def test_non_finite_raises_not_emits(self):
        codec = ResponseCodec()
        for bad in (float("nan"), float("inf"), float("-inf")):
            with pytest.raises(ValueError):
                codec.encode("winprob", {"version": 1, "p_a": bad, "quality": 1.0})
            with pytest.raises(ValueError):
                codec.encode("tiers", {"version": 1, "edges": [bad], "counts": [0],
                                       "rated": 0})

    def test_arena_grows_for_large_bodies(self):
        codec = ResponseCodec(arena_bytes=64)
        leaders = [{"rank": i + 1, "id": f"p{i}", "mu": 1500.0 + i / 3,
                    "sigma": 80.0 + i / 7, "conservative": 1260.0 + i / 9}
                   for i in range(3000)]
        obj = {"version": 9, "leaders": leaders}
        assert codec.encode("leaderboard", obj) == oracle_bytes(obj)
        assert codec.fallbacks == 0


# ---------------------------------------------------------------------------
class TestFollowerGroup:
    def test_replicas_serve_leader_bytes_within_staleness(self):
        pub, ids, engine, door = make_plane()
        group = FollowerGroup(pub, cfg=CFG, n_followers=3, refresh_interval_s=0.003)
        group.start()
        try:
            assert len(group.urls) == 3
            group.refresh()
            assert group.versions == [pub.version] * 3
            for target in ["/v1/leaderboard?k=5", "/v1/ratings?ids=p0,p50",
                           "/v1/winprob?a=p0&b=p1", "/v1/tiers?score=1500.0",
                           "/v1/ratings?ids=ghost"]:
                leader = get_raw(door.port, target)[2]
                bodies = {get_raw(d.port, target)[2] for d in group.doors}
                assert bodies == {leader}, target
            for plane in group.planes:
                assert plane.publisher.current().table is pub.current().table
            pub.publish_rows(ids, rated_table(60, 45, 9))
            deadline = time.monotonic() + 5.0
            while group.versions != [pub.version] * 3:
                assert time.monotonic() < deadline, group.versions
                time.sleep(0.005)
            target = "/v1/leaderboard?k=8"
            leader = get_raw(door.port, target)[2]
            assert json.loads(leader)["version"] == pub.version == 2
            for d in group.doors:
                assert get_raw(d.port, target)[2] == leader
        finally:
            group.close()
            door.close()
            engine.close()


# ---------------------------------------------------------------------------
class TestSoakBitIdentity:
    def test_serve_http_block_matches_in_process(self):
        from analyzer_tpu_torch.loadgen.driver import SoakConfig, SoakDriver

        base = dict(seed=5, duration_s=2.0, tick_s=1.0, qps=8.0, query_qps=5.0,
                    n_players=80, batch_size=32, polls_per_tick=4)
        blocks = []
        for kw in (dict(use_http=False), dict(serve_http=True)):
            reset_registry()
            driver = SoakDriver(SoakConfig(**base, **kw), device="cpu")
            try:
                art = driver.run()
            finally:
                driver.close()
            if kw.get("serve_http"):
                assert art["frontdoor"]["encodes"] > 0
                assert art["frontdoor"]["native"]
            else:
                assert "frontdoor" not in art
            blocks.append(json.dumps(art["deterministic"], sort_keys=True))
        assert blocks[0] == blocks[1]
