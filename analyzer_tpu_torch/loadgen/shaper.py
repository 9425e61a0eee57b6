"""Virtual clock and deterministic traffic shaping for the soak loop.

The soak's whole determinism story hangs on two facts owned here:

  * **VirtualClock** — every pacing decision (idle-timeout flushes,
    queue-depth sampling throttles, tick boundaries) reads a clock the
    driver ADVANCES explicitly, never the wall. The same seed + config
    therefore replays the identical event order on any machine at any
    speed; wall time only ever appears in the artifact's *measured*
    block (latencies, wall throughput), which is explicitly outside the
    bit-identical contract.
  * **TrafficShaper** — fractional rates (e.g. 7.5 matches/s at a 0.4 s
    tick) become integer per-tick event counts through an error-carrying
    accumulator, so the long-run rate is exact and the per-tick sequence
    is a pure function of (rate, tick_s) — no RNG, no rounding drift.

No ``random.*``, no seedless ``np.random.default_rng()`` and no
wall-clock read sits in a decision path of this package.

The port's copy of ``analyzer_tpu.loadgen.shaper``: the same counts on the
same (rate, tick), and the same kind draws on the same generator.
"""

from __future__ import annotations


class VirtualClock:
    """A monotonic clock whose only mutator is :meth:`advance`.

    Hand :meth:`monotonic` to ``Worker(clock=)`` and anything else that
    wants a ``time.monotonic``-shaped callable; the driver advances it
    once per tick (and per drain iteration), so "one second elapsed" is
    a statement about the SIMULATED schedule, not about the host.
    """

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"virtual time cannot rewind (dt={dt})")
        self._now += float(dt)
        return self._now

    def monotonic(self) -> float:
        """The ``time.monotonic``-shaped read (bound-method friendly)."""
        return self._now


class TrafficShaper:
    """Deterministic integer event counts per tick from a fractional
    rate.

    ``due()`` is called exactly once per tick: the accumulator gains
    ``rate * tick_s``, the integer part is emitted, the fraction carries
    — so e.g. 2.5 events/tick yields 2, 3, 2, 3, ... and the cumulative
    count after N ticks is always ``floor(N * rate * tick_s)`` ± 1.
    """

    __slots__ = ("rate_per_s", "tick_s", "_acc")

    def __init__(self, rate_per_s: float, tick_s: float) -> None:
        if rate_per_s < 0 or tick_s <= 0:
            raise ValueError(
                f"need rate >= 0 and tick > 0 (got {rate_per_s}, {tick_s})"
            )
        self.rate_per_s = float(rate_per_s)
        self.tick_s = float(tick_s)
        self._acc = 0.0

    def due(self) -> int:
        self._acc += self.rate_per_s * self.tick_s
        n = int(self._acc)
        self._acc -= n
        return n


#: Default serve-query mix for the soak's concurrent read workload:
#: point lookups dominate (the production shape), with a steady trickle
#: of winprob, leaderboard, and tier-histogram traffic.
DEFAULT_QUERY_MIX = (
    ("ratings", 0.50),
    ("winprob", 0.25),
    ("leaderboard", 0.15),
    ("tiers", 0.10),
)


def choose_kind(rng, mix=DEFAULT_QUERY_MIX) -> str:
    """One deterministic draw from the (kind, weight) mix using exactly
    one ``rng`` stream read."""
    total = sum(w for _, w in mix)
    x = rng.random() * total
    for kind, w in mix:
        x -= w
        if x < 0:
            return kind
    return mix[-1][0]
