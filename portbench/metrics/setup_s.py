"""Set-up: from the process's start to the window's first issue (imports,
kernel libraries, weights, cache, warm-up), on the host's clock."""


def read(run):
    return run.setup_s
