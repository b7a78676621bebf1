"""Process start to the window's opening: imports, kernel builds
(a first run in a checkout), content, warm-up."""


def read(rec):
    return rec.get("setup_s")
