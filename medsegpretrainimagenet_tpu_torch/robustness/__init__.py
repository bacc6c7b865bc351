"""Transferability ("robustness") scoring of pretrained encoders: the port
of ``medsegpretrainimagenet_tpu/robustness``.

Margin scores over per-level encoder activations of two differently
color-jittered views, with cosine / L2 / inverse-Pearson distances, and a
sweep that writes the reference's ``results/robustness_scores.csv``
columns.  ``python -m medsegpretrainimagenet_tpu_torch.robustness cfg.yaml
[--device cpu]`` runs a sweep from a config.
"""
from .distances import cosine_distance, inv_pearson_corr, l2_loss
from .eval import (JitterDraws, Robustness, apply_color_jitter,
                   eval_encoder, jitter_draws, predict_w_model)
from .sweep import run_sweep, write_scores_csv

__all__ = ["Robustness", "eval_encoder", "predict_w_model",
           "apply_color_jitter", "jitter_draws", "JitterDraws",
           "cosine_distance", "l2_loss", "inv_pearson_corr", "run_sweep",
           "write_scores_csv"]
