"""Transferability sweep CLI: the port of the JAX package's
``python -m medsegpretrainimagenet_tpu.robustness cfg.yaml``.

    python -m medsegpretrainimagenet_tpu_torch.robustness cfg.yaml
        [--device cpu]

It runs on the card unless ``--device`` names another device, and raises
before any work when there is no card and no ``--device``.  The YAML names
probe datasets (built through the registry, probe images taken from the
train split), encoders (a model config, optional checkpoint weights and
metadata) and the sweep axes:

```yaml
data:
  COVIDQUDataset:
    segmentation.datasets.COVIDQUDataset:
      lung_or_infection: inf
      image_sizes: 224
probe_images: 64
encoders:
  - name: unet_encoder
    pretraining_scheme: simple
    pretraining_length: 20
    weights: ../encoder_weights/..._epoch_20.pt   # optional
    model:
      segmentation.models.UNet_encoder:
        in_channel_size: 3
metrics: [cosine_distance, l2, inv_pearson]
margins: [0.0, 0.5]
levels: [1, 2, 3, 4]
pooled: [false, true]
output: robustness_scores.csv
seed: 0
```

``weights`` takes the port's own checkpoints (a pretraining run's
``model_state_dict_epoch_N.pt``, whose ``layers.0.`` subtree is the
encoder) and the reference's torch state dicts of the U-Net, Swin and
ResNet encoders (translated by ``train.torch_mapping``).  The CSV has the
JAX CLI's columns and row order.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["main", "load_probes", "build_encoders"]


def load_probes(cfg, seed: int, n_probe: int) -> Dict[str, np.ndarray]:
    """Probe images per dataset alias: the first *n_probe* of the train
    split, NHWC float32 in [0, 1], in their native channel count."""
    from ..config import registry
    from ..data import Dataset

    datasets: Dict[str, np.ndarray] = {}
    for alias in cfg["data"].keys():
        ds = registry.build(cfg[f"data/{alias}"].trim(), wrapper=Dataset,
                            seed=seed)
        imgs = np.asarray(ds.train["x"][:n_probe], np.float32)
        if imgs.max() > 1.5:
            # uint8_transfer datasets ship 0-255; the color jitter and the
            # encoders expect [0, 1]
            imgs = imgs / 255.0
        # the native channel count stays: 1 -> N repeats happen per
        # encoder in run_sweep (a 1-channel encoder must not probe
        # 3-channel images)
        name = alias.split(".")[-1]
        if name in datasets:
            # two aliases sharing a final component must not overwrite each
            # other in the CSV's dataset column
            print(f"warning: dataset short name {name!r} already used; "
                  f"keying {alias!r} by its full alias")
            name = alias
        datasets[name] = imgs
    return datasets


def _load_weights(module: torch.nn.Module, weights: str) -> None:
    """Graft an encoder checkpoint into *module*, parameters and BatchNorm
    running statistics, printing what does not line up: a checkpoint that
    does not match the encoder must not load as a silent no-op."""
    from ..models.wrapper import _graft
    from ..train.checkpoint import is_stat, load_encoder_variables
    from ..train.torch_mapping import (looks_like_torch_encoder,
                                       translate_reference_encoder)

    params, stats = load_encoder_variables(weights)
    if looks_like_torch_encoder(params):
        translated, leftover = translate_reference_encoder(
            {**params, **(stats or {})})
        if leftover:
            print(f"warning: unmapped torch keys in {weights}: "
                  f"{leftover[:6]}")
        params = {k: v for k, v in translated.items() if not is_stat(k)}
        stats = {k: v for k, v in translated.items() if is_stat(k)}

    def report(missing, unexpected):
        if missing:
            print(f"warning: {len(missing)} params of the encoder not in "
                  f"{weights} (left random), e.g. {missing[:4]}")
        if unexpected:
            print(f"warning: {len(unexpected)} keys of {weights} unused, "
                  f"e.g. {unexpected[:4]}")

    # the batch count is no statistic the JAX package keeps
    def statistics(state):
        return {k: v for k, v in (state or {}).items() if is_stat(k)
                and not k.endswith("num_batches_tracked")}

    state = module.state_dict()
    _graft({k: v for k, v in state.items() if not is_stat(k)}, params,
           report)
    if stats and statistics(state):
        # the probe forward runs in eval mode and normalises with them
        _graft(statistics(state), statistics(stats), report)


def build_encoders(cfg, datasets: Dict[str, np.ndarray], seed: int,
                   device: torch.device) -> List[Dict[str, Any]]:
    """The config's encoders on *device*, initialised from *seed* and
    loaded from their ``weights``, as ``run_sweep`` takes them."""
    from ..config import registry
    from ..models import Model
    from ..predict import _model_in_channels

    first = datasets[next(iter(datasets))]
    encoders = []
    for enc_cfg in cfg.elements_of("encoders"):
        # probe with the encoder's own channel count.  An encoder that
        # declares none (DeepResNet) takes the probes as they are, and its
        # stem is sized for them, as flax sizes it from the init sample
        want = _model_in_channels(enc_cfg)
        model = registry.build(enc_cfg["model"].trim(), wrapper=Model,
                               filter_kwargs=True,
                               in_channels=want or first.shape[-1])
        if want is None:
            want = getattr(model.module, "in_channel_size", None)
        model.init(seed)
        model.module.to(device)
        weights = enc_cfg.get("weights")
        if weights:
            _load_weights(model.module, weights)
        encoders.append({
            "module": model.module,
            "name": enc_cfg.get("name", "encoder"),
            "pretraining_scheme": enc_cfg.get("pretraining_scheme", "none"),
            "pretraining_length": enc_cfg.get("pretraining_length", 0),
            "in_channels": want,
        })
    return encoders


def main(argv=None) -> int:
    import yaml

    from ..cli.experiment import _pop_device
    from ..config import ConfigDict
    from ..utils.device import resolve_device
    from .sweep import run_sweep, write_scores_csv

    device, argv = _pop_device(list(argv if argv is not None
                                    else sys.argv[1:]))
    if not argv:
        print(__doc__)
        return 1
    device = resolve_device(device)
    with open(argv[0]) as fh:
        cfg = ConfigDict(yaml.full_load(fh))

    seed = cfg.get("seed", 0)
    n_probe = cfg.get("probe_images", 64)
    if n_probe % 2:
        print(f"warning: odd probe_images ({n_probe}) — the reversed+"
              f"rolled negative pairing self-matches one index "
              f"(reference eval.py:20-24 quirk); use an even count")

    datasets = load_probes(cfg, seed, n_probe)
    encoders = build_encoders(cfg, datasets, seed, device)
    rows = run_sweep(
        encoders, datasets,
        metrics=cfg.get_str_tuple("metrics") or ("cosine_distance", "l2",
                                                 "inv_pearson"),
        margins=cfg.get_tuple("margins", (0.0, 0.5)),
        levels=cfg.get_tuple("levels", (1, 2, 3, 4)),
        pooled=tuple(bool(p) for p in cfg.get_tuple("pooled",
                                                    (False, True))),
        batch_size=cfg.get("batch_size", 32), seed=seed)
    out = cfg.get("output", "robustness_scores.csv")
    write_scores_csv(out, rows)
    print(f"wrote {len(rows)} rows to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
