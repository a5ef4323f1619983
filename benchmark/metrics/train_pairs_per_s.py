"""Sampled BPR pairs times the epochs finished, over the window's wall:
``train_ratings_per_s``'s formula."""

from benchmark import harness

read = harness.reader("train_ratings_per_s")
