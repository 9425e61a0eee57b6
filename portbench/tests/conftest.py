"""Tiny sizes of the cells added after ``_tiny.py`` was written, merged into
its ``TINY`` before any test module is collected, so that every test that
walks ``TINY`` runs them too."""

import _tiny

_tiny.TINY.setdefault("backfill10m.migrate_fused",
                      {"players": 3000, "matches": 30000,
                       "warmup_matches": 3000, "checkpoint_every": 64})
