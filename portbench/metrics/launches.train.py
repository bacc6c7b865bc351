"""``launches.train``: kernels launched a training step in the trace; a
count."""


def read(record):
    if record is None or record.kind != "train" or not record.trace.device:
        return None
    return len(record.trace.kernels()) / record.steps
