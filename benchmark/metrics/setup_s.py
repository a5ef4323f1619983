"""Set-up: process start to the window's start (card init, inputs made,
the program built and staged, the cell's shapes warmed)."""


def read(rec):
    return rec["setup_s"]
