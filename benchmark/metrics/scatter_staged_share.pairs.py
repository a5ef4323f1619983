"""``scatter_staged_share.sgd``'s reading on the BPR cell, which moves
``train_pairs_per_s``."""

from benchmark import harness

read = harness.reader("scatter_staged_share.sgd")
