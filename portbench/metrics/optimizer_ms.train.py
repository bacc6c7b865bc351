"""``optimizer_ms.train``: device ms a training step in the kernels launched
inside the port's ``medseg.optimizer`` span (the gradient scaling, norm and
clip, the learning rate and the update), over the steps traced with the
host's ranges; None on a program without the span."""

SPAN = "medseg.optimizer"


def read(record):
    if record is None or record.kind != "train" or record.spans is None:
        return None
    spent = sum(k.dur for k in record.spans.in_span(SPAN))
    return 1e3 * spent / record.span_steps if spent > 0 else None
