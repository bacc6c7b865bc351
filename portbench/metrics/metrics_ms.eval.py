"""``metrics_ms.eval``: device ms an evaluation step in the kernels
launched from inside the benchmark's ``metrics`` range (each call into the
metric calculator), over the steps traced with the host's ranges."""


def read(record):
    if record is None or record.kind != "eval" or record.spans is None:
        return None
    spent = sum(k.dur for k in record.spans.in_span("metrics"))
    return 1e3 * spent / record.span_steps if spent > 0 else None
