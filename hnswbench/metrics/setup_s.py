"""setup_s: process start to the first timed request or build."""


def read(run):
    return run.setup_s
