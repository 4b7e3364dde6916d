"""setup_s: process start to the first timed window or pass (host
clock): imports, the graph and traffic made from the seed, the program's
build, its set-up (static coreness, the session) and the warm-up."""


def read(run):
    return run.setup_s
