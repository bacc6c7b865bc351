"""Compute kernels written by hand for Hopper, each beside its plain
PyTorch version."""
from .layer_norm import (layer_norm_backward_cuda,  # noqa: F401
                         layer_norm_cuda, layer_norm_torch)
from .window_attention import (fused_image_window_attention,  # noqa: F401
                               image_attention_cuda, image_attention_torch,
                               set_fused_image_mode, use_fused_image,
                               window_attention_core, window_attention_cuda,
                               window_attention_torch)

__all__ = ["window_attention_core", "window_attention_cuda",
           "window_attention_torch", "fused_image_window_attention",
           "image_attention_cuda", "image_attention_torch",
           "set_fused_image_mode", "use_fused_image", "layer_norm_cuda",
           "layer_norm_backward_cuda", "layer_norm_torch"]
