"""``norm_ms.train``: device ms a training step in LayerNorm and
BatchNorm kernels, forward and backward."""
from portbench.groups import NORM, group_of


def read(record):
    if record is None or record.kind != "train" or not record.trace.device:
        return None
    spent = sum(k.dur for k in record.trace.kernels()
                if group_of(k.name, NORM))
    return 1e3 * spent / record.steps if spent > 0 else None
