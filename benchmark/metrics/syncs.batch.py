"""``syncs.serve``'s reading on the batch cell, which moves
``topn_users_per_s``."""

from benchmark import harness

read = harness.reader("syncs.serve")
