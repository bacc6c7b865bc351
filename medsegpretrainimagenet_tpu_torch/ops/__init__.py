"""Compute kernels written by hand for Hopper, each beside its plain
PyTorch version."""
from .window_attention import (fused_image_window_attention,  # noqa: F401
                               image_attention_cuda, image_attention_torch,
                               set_fused_image_mode, use_fused_image,
                               window_attention_core, window_attention_cuda,
                               window_attention_torch)

__all__ = ["window_attention_core", "window_attention_cuda",
           "window_attention_torch", "fused_image_window_attention",
           "image_attention_cuda", "image_attention_torch",
           "set_fused_image_mode", "use_fused_image"]
