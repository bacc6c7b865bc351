"""``backward_ms.train``: device ms a training step in the kernels launched
inside the port's ``medseg.backward`` spans (each fragment's
``loss.backward()``, whose kernels the autograd engine's thread launches
while the step's thread waits inside the span), over the steps traced with
the host's ranges; None on a program without the span."""

SPAN = "medseg.backward"


def read(record):
    if record is None or record.kind != "train" or record.spans is None:
        return None
    spent = sum(k.dur for k in record.spans.in_span(SPAN))
    return 1e3 * spent / record.span_steps if spent > 0 else None
