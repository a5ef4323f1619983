"""``idle_share.ratings``'s reading on a BPR cell, which moves
``train_pairs_per_s``."""

from benchmark import harness

read = harness.reader("idle_share.ratings")
