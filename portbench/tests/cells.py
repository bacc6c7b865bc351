"""Small cells for the CPU tests: the benchmark's own cells with the
configurations cut to a few channels and 32 x 32 images."""
from __future__ import annotations

import copy

from portbench import spec


def small_cell(name: str, batch: int = 4, compute_dtype: str = "float32"):
    """The cell *name* at a size the CPU runs in a second or two."""
    cell = spec.load_cell(name)
    cell = copy.deepcopy(cell)
    arch = cell.config["tree"]["model"]["segmentation.models.UNet"][
        "architecture"]
    block = arch.get("basic_block", {}).get(
        "segmentation.models.blocks.SwinTransformerBlock")
    if block is not None:
        arch.update(channels=[8, 16], depth=1)
        block.update(img_size=32, embed_dim=8, num_heads_layers=[2, 4],
                     window_size=4)
    else:
        arch.update(channels=[8, 16, 32], depth=2)
    cell.config["image_size"] = 32
    cell.traffic.update(batch=batch, pool=4)
    cell.workload["compute_dtype"] = compute_dtype
    return cell
