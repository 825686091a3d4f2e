"""setup_s: seconds from the process's start to the window's start (imports,
kernel build or load, operator build, encodes, warm-up)."""


def read(rec):
    return rec.setup_s
