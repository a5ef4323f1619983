"""``card_wait_ms.serve``'s reading on the batch cell, which moves
``topn_users_per_s``."""

from benchmark import harness

read = harness.reader("card_wait_ms.serve")
