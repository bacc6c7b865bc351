"""Batch inference (serving) CLI: the port of ``predict/__init__.py``.

A trained checkpoint (a ``.pt`` state dict; a JAX msgpack checkpoint
converts with ``transfer.state_dict_from_jax``) serves directly:

    python -m medsegpretrainimagenet_tpu_torch.predict config.yaml \
        --checkpoint w.pt --input imgs.npy --output preds.npy \
        [--batch 32] [--threshold 0.5] [--mixed-precision]

Serving choices, as in the JAX package:

* uint8 batches ship to the device as they are, from pinned memory with a
  non-blocking copy, and dequantise (float/255) there: 4x less host-to-device
  traffic;
* thresholding / argmax run on the device, so only the final masks come
  back;
* the next batch is queued on the device before the previous one is read
  back, so copies and forwards overlap;
* the last partial batch is zero-padded to the batch size and the padding
  dropped on the host;
* ``--mixed-precision`` switches block compute to bf16; Swin models then run
  their window attention through the hand-written CUDA kernel.

Runs on CUDA unless ``device="cpu"`` (``--device cpu``) is asked for.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ConfigDict, registry
from ..data.warp import resize
from ..utils.device import resolve_device
from ..utils.errors import handle_exception

__all__ = ["predict_from_config", "resolve_device", "main"]


def _to_nhwc(imgs: np.ndarray) -> np.ndarray:
    """Accept (N,H,W), (N,C,H,W) channels-first or (N,H,W,C) and return
    NHWC (the reference stores npy stacks channels-first)."""
    if imgs.ndim == 3:
        return imgs[..., None]
    if imgs.ndim != 4:
        raise ValueError(f"expected 3-D or 4-D image stack, got {imgs.shape}")
    if imgs.shape[1] <= 4 < imgs.shape[-1]:
        return np.transpose(imgs, (0, 2, 3, 1))
    return imgs


def _model_in_channels(config_dict: ConfigDict) -> Optional[int]:
    spec = config_dict["model"].value()
    for path in ("architecture/in_channel_size", "in_channel_size",
                 "architecture/img_ch", "img_ch"):
        value = spec.get(path) if hasattr(spec, "get") else None
        if value is not None:
            try:
                return int(value)
            except (TypeError, ValueError):
                return None
    return None


def predict_from_config(config: Any, checkpoint: str, input_path: str,
                        output_path: str, batch_size: int = 16,
                        threshold: Optional[float] = None,
                        argmax: bool = False,
                        mixed_precision: Optional[bool] = None,
                        repeat_channels: Optional[bool] = None,
                        image_size: Optional[Any] = None,
                        device: Optional[str] = None) -> Dict[str, Any]:
    """Run batched inference; returns a stats dict (also printed by the
    CLI as one JSON line)."""
    from ..models.blocks import compute_dtype, set_compute_dtype

    dev = resolve_device(device)
    if not isinstance(config, ConfigDict):
        config = ConfigDict.from_yaml(config)
    config.expand()
    registry.fill_spec(config, "model")

    tech = config.get("meta/technical", ConfigDict({}))
    if mixed_precision is None:
        mixed_precision = bool(tech.get("mixed_precision", False))
    # the compute dtype is process-global; restore it on exit so an
    # in-process caller's later models are not silently flipped
    prev_dtype = compute_dtype()
    set_compute_dtype(torch.bfloat16 if mixed_precision else None)
    try:
        return _predict(config, checkpoint, input_path, output_path,
                        batch_size, threshold, argmax, mixed_precision,
                        repeat_channels, image_size, dev)
    finally:
        set_compute_dtype(prev_dtype)


def _predict(config, checkpoint, input_path, output_path, batch_size,
             threshold, argmax, mixed_precision, repeat_channels,
             image_size, dev: torch.device) -> Dict[str, Any]:
    from ..models import Model
    from ..train import checkpoint as ckpt

    model = registry.build(config, key="model", wrapper=Model)
    module = model.module
    module.load_state_dict(ckpt.load_params_file(checkpoint))
    module.to(dev).eval()

    imgs = np.load(input_path, mmap_mode="r")
    n_total = imgs.shape[0]
    if n_total == 0:
        raise ValueError(f"input stack {input_path!r} is empty "
                         f"(shape {imgs.shape})")
    channels = _to_nhwc(imgs[:1]).shape[-1]
    # float stacks scaled 0-255 normalise like the readers do; probe a
    # stride-sampled subset, since leading frames can be blank
    scale_float = False
    if imgs.dtype != np.uint8:
        stride = max(1, n_total // 64)
        scale_float = float(np.asarray(imgs[::stride]).max()) > 1.5
    if repeat_channels is None:
        want = _model_in_channels(config)
        repeat_channels = bool(want and want == 3 and channels == 1)
    if image_size is not None and np.ndim(image_size) == 0:
        image_size = (int(image_size), int(image_size))
    on_cuda = dev.type == "cuda"

    def host_batch(lo: int, hi: int) -> torch.Tensor:
        x = _to_nhwc(np.asarray(imgs[lo:hi]))
        if image_size is not None and tuple(x.shape[1:3]) != tuple(image_size):
            # bilinear, the readers' image path (OpenCV's INTER_LINEAR)
            x = np.stack([resize(img, image_size) for img in x])
        if repeat_channels:
            x = np.repeat(x, 3, axis=-1)
        if x.shape[0] < batch_size:  # zero-pad the last partial batch
            pad = np.zeros((batch_size - x.shape[0],) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(x))
        return x.pin_memory() if on_cuda else x

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        x = x.to(dev, non_blocking=True)
        if x.dtype == torch.uint8 or scale_float:
            x = x.float() / 255.0
        pred = module(x.float()).float()
        if argmax and pred.shape[-1] > 1:
            return torch.argmax(pred, dim=-1).to(torch.uint8)
        if threshold is not None:
            return (pred[..., 0] >= threshold).to(torch.uint8) \
                if pred.shape[-1] == 1 else (pred >= threshold).to(torch.uint8)
        return pred

    def read_back(out: torch.Tensor):
        """Queue the device-to-host copy; returns (host tensor, event)."""
        if not on_cuda:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    outs = []
    # pipelined dispatch: batch i+1 is queued (copy in, forward, copy out)
    # before batch i's result is waited for
    pending = None
    t0 = time.perf_counter()
    for lo in range(0, n_total, batch_size):
        queued = read_back(forward(host_batch(lo, min(lo + batch_size,
                                                       n_total))))
        if pending is not None:
            outs.append(_wait(*pending))
        pending = queued
    outs.append(_wait(*pending))
    dt = time.perf_counter() - t0

    preds = np.concatenate(outs, axis=0)[:n_total]
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    np.save(output_path, preds)
    return {"images": int(n_total), "seconds": round(dt, 4),
            "images_per_sec": round(n_total / dt, 2),
            "output": output_path, "shape": list(preds.shape),
            "dtype": str(preds.dtype),
            "mixed_precision": bool(mixed_precision), "device": str(dev)}


def _wait(host: torch.Tensor, event) -> np.ndarray:
    if event is not None:
        event.synchronize()
    return host.numpy()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m medsegpretrainimagenet_tpu_torch.predict",
        description="Batched GPU inference from an experiment config + "
                    "checkpoint.")
    parser.add_argument("config", help="experiment YAML (model section is "
                                       "used)")
    parser.add_argument("--checkpoint", required=True,
                        help="model state dict (*.pt)")
    parser.add_argument("--input", required=True,
                        help=".npy image stack: (N,H,W), (N,C,H,W) or "
                             "(N,H,W,C); uint8 stacks ship as-is and "
                             "dequantize on device")
    parser.add_argument("--output", required=True, help="output .npy path")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--threshold", type=float, default=None,
                        help="binarize sigmoid outputs at this threshold "
                             "(uint8 output)")
    parser.add_argument("--argmax", action="store_true",
                        help="argmax multiclass outputs to class ids")
    parser.add_argument("--mixed-precision",
                        action=argparse.BooleanOptionalAction,
                        default=None, help="bf16 block compute (default: "
                                           "the config's "
                                           "meta/technical/mixed_precision)")
    parser.add_argument("--repeat-channels",
                        action=argparse.BooleanOptionalAction,
                        default=None,
                        help="repeat grayscale inputs to 3 channels "
                             "(auto-detected from the model config when "
                             "omitted)")
    parser.add_argument("--image-size", type=int, default=None,
                        help="resize inputs to this square size before "
                             "inference (match the training image_sizes)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                             "plain PyTorch versions of the kernels)")
    args = parser.parse_args(argv)
    try:
        stats = predict_from_config(
            args.config, args.checkpoint, args.input, args.output,
            batch_size=args.batch, threshold=args.threshold,
            argmax=args.argmax, mixed_precision=args.mixed_precision,
            repeat_channels=args.repeat_channels,
            image_size=args.image_size, device=args.device)
    except Exception as exc:  # noqa: BLE001 — CLI envelope
        handle_exception(exc, "Exception during prediction.")
        return 1
    print(json.dumps(stats))
    return 0
