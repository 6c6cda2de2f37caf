"""Host milliseconds per batch inside the port's ``ae.nll`` span: the
validation's NLL: its encode and teacher-forced decode. Inclusive of the
spans inside it, read in the run's segment with the program's tracer on
and no profiler (``harness.py``), over that segment's batches. In a
card-paced cell the span also holds the host's waits in a full launch
queue, so there it reads the card's pace, not the host's issue alone."""

from vqabench.trace import span_seconds


def read(m):
    seconds = span_seconds(m, "ae.nll")
    return None if seconds is None else 1e3 * seconds / m.traced.steps
