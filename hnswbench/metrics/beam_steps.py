"""beam_steps: level-0 beam steps a request, from the program's counter
``tpu_hnsw_torch.index.search.BEAM_STEPS`` over the program-traced
window's requests (the steps do not depend on the profiler). ``before``
and ``after`` read the counter around that window; against a program
without the counter the reader reads None."""

from __future__ import annotations


def _counter():
    from tpu_hnsw_torch.index import search

    return getattr(search, "BEAM_STEPS", None)


def before(run):
    run.extra["beam_steps0"] = _counter()


def after(run):
    s0 = run.extra.pop("beam_steps0", None)
    if s0 is not None:
        run.extra["beam_steps"] = _counter() - s0


def read(run):
    steps = run.extra.get("beam_steps")
    if steps is None or not run.traced.records:
        return None
    return steps / len(run.traced.records)
