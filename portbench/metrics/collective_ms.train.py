"""``collective_ms.train``: device ms a training step in the NCCL kernels
(the gradient all-reduce, BatchNorm's all-gathers and sums, the
predictions' all-gather) on rank 0's card, by kernel name; None on one
card, where there are none."""
from portbench.groups import NCCL, group_of


def read(record):
    if record is None or record.kind != "train" or not record.trace.device:
        return None
    spent = sum(k.dur for k in record.trace.kernels()
                if group_of(k.name, NCCL))
    return 1e3 * spent / record.steps if spent > 0 else None
