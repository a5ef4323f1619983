"""``sync_ms.ratings``'s reading on the BPR cell, which moves
``train_pairs_per_s``."""

from benchmark import harness

read = harness.reader("sync_ms.ratings")
