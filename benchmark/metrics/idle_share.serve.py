"""``idle_share.ratings``'s reading on the single-user serving cell, over
its requests sent back to back: moves ``topn_p95_ms``."""

from benchmark import harness

read = harness.reader("idle_share.ratings")
