"""launches.graph: device operations launched inside the program's `search`
span (``HnswIndex.search_device``), per request, in the window traced on
the device alone (:func:`hnswbench.program_spans.launches_per_request`)."""

from hnswbench import program_spans

program_spans.install()
before, after = program_spans.pause, program_spans.resume
read = program_spans.launches_per_request
