"""setup_s: process start to the window's start, on the host clock."""


def read(rec):
    return rec["setup_s"]
