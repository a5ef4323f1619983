"""``train_ratings_per_s``'s formula on the scatter engine's cell, under a
name of its own because the host-bound engine spreads far more from run
to run than the stripe engine, and each metric takes one bound."""

from benchmark import harness

read = harness.reader("train_ratings_per_s")
