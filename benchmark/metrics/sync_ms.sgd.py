"""``sync_ms.ratings``'s reading on the scatter engine's cell, which moves
``sgd_ratings_per_s``."""

from benchmark import harness

read = harness.reader("sync_ms.ratings")
