"""queries_ms.interactive: median host ms a request spends in the
program's `queries` span (validation, pinned staging and the upload), in
the untraced span window."""

from hnswbench import program_spans

program_spans.install()
before, after = program_spans.pause, program_spans.resume


def read(run):
    return program_spans.span_ms(run.spans, "queries")
