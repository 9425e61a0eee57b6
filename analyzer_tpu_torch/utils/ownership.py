"""Which thread a function runs on, declared where it is defined.

The threaded pieces of the port (the migration engine's front half and its
consumer, the feed ring, the tier manager) split their state between a
producer thread and a consumer thread. ``thread_role`` stamps a function
with its side of that split. It costs nothing at run time: the decorator
sets ``__thread_role__`` on the function and returns the function itself.

The port's copy of the decorator of ``analyzer_tpu.lint.ownership``, under
the same name, so a lint pass that resolves any name ending in
``thread_role`` reads the port's annotations as it reads the JAX
package's.
"""

from __future__ import annotations

ROLES = ("producer", "consumer", "any")


def thread_role(role: str):
    """Declares which thread a function runs on: ``producer`` or
    ``consumer`` name the two sides of a documented handoff, ``any`` an
    entry point safe from either side (one that takes the instance lock,
    or a lock-free reader)."""
    if role not in ROLES:
        raise ValueError(f"thread_role must be one of {ROLES}, got {role!r}")

    def mark(fn):
        fn.__thread_role__ = role
        return fn

    return mark
