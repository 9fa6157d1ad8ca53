"""Seconds from the process's start (the launcher's, over several cards) to
the first step of the window (host clock)."""


def read(run):
    return run.setup_s
