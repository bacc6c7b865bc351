"""``hd95_percentile_ms.eval``: device ms an evaluation step in the kernels
launched inside the port's ``medseg.hd95.percentile`` span (HD95's masked
95th percentile: a sort and a gather), over the steps traced with the host's
ranges; None on a program without the span."""

SPAN = "medseg.hd95.percentile"


def read(record):
    if record is None or record.kind != "eval" or record.spans is None:
        return None
    spent = sum(k.dur for k in record.spans.in_span(SPAN))
    return 1e3 * spent / record.span_steps if spent > 0 else None
