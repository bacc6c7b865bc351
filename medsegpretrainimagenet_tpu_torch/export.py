"""Model export for serving: the port of ``medsegpretrainimagenet_tpu/
export.py``.

    python -m medsegpretrainimagenet_tpu_torch.export config.yaml \
        --checkpoint run_1/best_model_state_dict.pt --output model.pt2 \
        [--size 256] [--channels 3] [--batch 0] [--mixed-precision] \
        [--device cpu]

The artifact is a ``torch.export`` ``ExportedProgram`` of the eval forward
with the weights inside, written with ``torch.export.save``.  Its input is
a ``(b, H, W, C)`` float32 batch and its output the model's NHWC output, as
for the JAX artifact.  ``--batch 0`` (the default) exports a symbolic batch
(any size at call time); a positive value pins a static batch, and another
size is then refused.  ``--mixed-precision`` traces the bf16 compute path.

An artifact traced on the card holds the window attention of a Swin model
as the port's registered operators, K1 (``medseg_torch::window_attention``)
or, under ``ops.set_fused_image_mode("on")``, K2
(``medseg_torch::image_attention``), and runs only on the card, as the JAX
artifact with a Pallas call runs only on a TPU.  One traced on the CPU holds
the plain PyTorch attention.  Loading needs no config and no checkpoint,
but it needs the operators registered: :func:`load_exported` imports
``ops``.
"""
from __future__ import annotations

import io
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

import torch

from .config import ConfigDict, registry
from .utils.device import resolve_device

__all__ = ["export_forward", "save_exported", "load_exported",
           "export_from_config", "main"]

#: the largest symbolic batch: on the card, eval BatchNorm takes cuDNN's
#: kernel up to this batch and the native one beyond, a branch on the
#: batch that one program cannot keep
MAX_BATCH = 65535


def export_forward(module: torch.nn.Module, input_shape: Sequence[int],
                   batch: Optional[int] = None,
                   dtype: torch.dtype = torch.float32
                   ) -> torch.export.ExportedProgram:
    """Trace *module*'s eval forward (no gradients) into an
    ``ExportedProgram`` holding its parameters and buffers.

    ``input_shape`` is the per-sample NHWC shape ``(H, W, C)``;
    ``batch=None`` exports a symbolic batch dimension ``b`` of 1 to
    :data:`MAX_BATCH`, a positive int pins it.  The sample lies where the
    module's parameters do."""
    module.eval()
    device = next(module.parameters()).device
    sample = torch.zeros((batch or 2, *input_shape), dtype=dtype,
                         device=device)
    dynamic = None if batch else (
        {0: torch.export.Dim("b", min=1, max=MAX_BATCH)},)
    with torch.no_grad():
        return torch.export.export(module, (sample,), dynamic_shapes=dynamic)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> int:
    """Write *exported* to *path* atomically; returns its size in bytes."""
    buffer = io.BytesIO()
    torch.export.save(exported, buffer)
    blob = buffer.getvalue()
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, path)  # a reader never sees a partial file
    return len(blob)


def load_exported(path: str):
    """The artifact at *path* as a callable ``f(x) -> output``.  No model
    code, config or checkpoint is read; the port's operator library is
    imported, since an artifact traced on the card calls K1 or K2."""
    from . import ops  # noqa: F401 - registers medseg_torch::* operators
    forward = torch.export.load(path).module()
    return forward.requires_grad_(False)


def _avals(exported: torch.export.ExportedProgram) -> list:
    """The outputs' dtypes and shapes, ``float32[b,256,256,1]``."""
    (out,) = [n for n in exported.graph.nodes if n.op == "output"]
    values = out.args[0]
    values = values if isinstance(values, (tuple, list)) else [values]
    avals = []
    for node in values:
        val = node.meta["val"]
        dims = ",".join(str(d) if isinstance(d, int) else "b"
                        for d in val.shape)
        avals.append(f"{str(val.dtype).replace('torch.', '')}[{dims}]")
    return avals


def export_from_config(config: Any, checkpoint: str, output_path: str,
                       image_size: int = 256, channels: int = 3,
                       batch: Optional[int] = None,
                       mixed_precision: bool = False,
                       device: Optional[str] = None) -> Dict[str, Any]:
    """Build the model from an experiment config, load the ``.pt``
    checkpoint, export it on *device* (the card unless named) and write the
    artifact.  Returns a stats dict."""
    from .models import Model
    from .models.blocks import compute_dtype, set_compute_dtype
    from .train import checkpoint as ckpt

    dev = resolve_device(device)
    if not isinstance(config, ConfigDict):
        config = ConfigDict.from_yaml(config)
    config.expand()
    registry.fill_spec(config, "model")

    previous = compute_dtype()
    set_compute_dtype(torch.bfloat16 if mixed_precision else None)
    try:
        model = registry.build(config, key="model", wrapper=Model)
        module = model.module
        module.load_state_dict(ckpt.load_params_file(checkpoint))
        module.to(dev)
        t0 = time.perf_counter()
        exported = export_forward(module, (image_size, image_size, channels),
                                  batch=batch)
        nbytes = save_exported(exported, output_path)
        return {
            "output": output_path,
            "bytes": nbytes,
            "batch": int(batch) if batch else "symbolic",
            "in_shape": [image_size, image_size, channels],
            "out_avals": _avals(exported),
            "platforms": [dev.type],
            "export_seconds": round(time.perf_counter() - t0, 2),
        }
    finally:
        set_compute_dtype(previous)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m medsegpretrainimagenet_tpu_torch.export",
        description="Export a trained model to a torch.export serving "
                    "artifact.")
    parser.add_argument("config", help="experiment config yaml (the "
                        "'model' section drives construction)")
    parser.add_argument("--checkpoint", required=True,
                        help=".pt state dict "
                             "(last/best_model_state_dict.pt)")
    parser.add_argument("--output", required=True,
                        help="artifact path (e.g. model.pt2)")
    parser.add_argument("--size", type=int, default=256,
                        help="square input resolution (default 256)")
    parser.add_argument("--channels", type=int, default=3,
                        help="input channels (default 3)")
    parser.add_argument("--batch", type=int, default=0,
                        help="0 = symbolic batch dim (default); a "
                             "positive value pins a static batch")
    parser.add_argument("--mixed-precision", action="store_true",
                        help="export the bf16 compute path")
    parser.add_argument("--device", default=None,
                        help="torch device to trace on (default: the "
                             "card; 'cpu' traces the plain attention)")
    args = parser.parse_args(argv)

    stats = export_from_config(
        args.config, args.checkpoint, args.output,
        image_size=args.size, channels=args.channels,
        batch=args.batch or None, mixed_precision=args.mixed_precision,
        device=args.device)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
