"""``idle_share.ratings``'s reading on the batch serving cell, which moves
``topn_users_per_s``."""

from benchmark import harness

read = harness.reader("idle_share.ratings")
