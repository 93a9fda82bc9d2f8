"""recall_at_10: recall@10 of the checked replies against the plain
reference's exact top-10."""


def read(run):
    return run.numbers["recall"]
