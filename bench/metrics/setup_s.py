"""Set-up: from the process's start to the window's start (host clock)."""


def read(rec):
    return rec["setup_s"]
