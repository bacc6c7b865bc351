"""Model wrapper: config -> torch module + parameter lifecycle.

The port of ``models/wrapper.py``'s ``Model``: construction from a
constructor and a config, seeded ``init``, ``apply``, the random
weight-init schemes of the config (``init_weight``), pretrained-weight
loading of the port's ``.pt`` state dicts (``load_weights``: parameters
strict or warned, BatchNorm statistics warned), the U-Net's encoder
transfer from a pretraining checkpoint (``weight_init/encoder``),
freezing, and parameter counts.  Where the JAX wrapper returns new
variables, this one changes the module in place and returns its state
dict.
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import ConfigDict
from ..config.registry import get_kwargs
from ..utils.errors import handle_exception
from .blocks import block_accepts
from .init import apply_init, init_module, init_spec_defaults

__all__ = ["Model"]


def _graft(target: Dict[str, torch.Tensor], loaded: Dict[str, torch.Tensor],
           on_mismatch: Callable) -> None:
    """Copy each loaded value into the target tensor of the same name.

    A value copies when its shape equals the target's, or is a pure
    squeeze/expand of it (non-unit dims equal in order, e.g. (C,) vs (1, 1,
    C)).  Equal element counts in another order (a transposed kernel) are
    a real mismatch: the target is left as it is and reported missing.
    *on_mismatch(missing, unexpected)* runs before anything is copied, so
    when it raises the target is unchanged."""
    def fits(value, dst):
        v_shape, t_shape = tuple(value.shape), tuple(dst.shape)
        return v_shape == t_shape or (tuple(d for d in v_shape if d != 1)
                                      == tuple(d for d in t_shape if d != 1))

    copies = {k: v for k, v in loaded.items()
              if k in target and fits(v, target[k])}
    missing = [k for k in target if k not in copies]
    unexpected = [k for k in loaded if k not in target]
    if missing or unexpected:
        on_mismatch(missing, unexpected)
    with torch.no_grad():
        for name, value in copies.items():
            dst = target[name]
            dst.copy_(value.reshape(dst.shape).to(dst.dtype))


class Model:
    """Host-side wrapper around a torch module built from config."""

    def __init__(self, constructor: Callable,
                 config_dict: Optional[ConfigDict] = None, *args, **kwargs):
        if config_dict is None:
            config_dict = ConfigDict()
        self.config_dict = config_dict
        model_kwargs = get_kwargs(constructor, config_dict)
        for kw in ("weight_init", "weight_initialisation"):
            if not block_accepts(constructor, kw):
                model_kwargs.pop(kw, None)
        model_kwargs.update(kwargs)
        self.module = constructor(*args, **model_kwargs)
        self.frozen_paths: Tuple[Tuple[str, ...], ...] = ()

    def init(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Re-initialise every parameter from a ``torch.Generator`` seeded
        with *seed* (on the CPU, wherever the module lies) and return the
        state dict.  The same seed gives the same weights every time."""
        generator = torch.Generator().manual_seed(seed)
        device = next(self.module.parameters()).device
        self.module.to("cpu")
        init_module(self.module, generator)
        self.module.to(device)
        return self.module.state_dict()

    def apply(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Forward in train or eval mode."""
        self.module.train(train)
        return self.module(x)

    # ------------------------------------------------------------------
    # weight initialisation (random schemes + pretrained weights)
    # ------------------------------------------------------------------

    @staticmethod
    def fill_weight_init_kwargs(config_dict: ConfigDict):
        """Inject defaults into the weight-init scheme configs."""
        def fill_scheme(init_dict: ConfigDict):
            if not isinstance(init_dict, ConfigDict):
                return
            name = init_dict.key() if len(init_dict) == 1 else None
            if name and not os.path.isfile(name):
                value = init_dict.value()
                if isinstance(value, ConfigDict):
                    value.fill_with_defaults(init_spec_defaults(name))

        config_dict.expand()
        for key in ("weight_initialisation", "weight_init"):
            if key not in config_dict:
                continue
            if f"{key}/random" in config_dict:
                key = f"{key}/random"
            entry = config_dict[key]
            if isinstance(entry, (tuple, list)):
                for init_dict in config_dict.elements_of(key):
                    fill_scheme(init_dict)
            elif isinstance(entry, ConfigDict) and len(entry.keys()) == 1:
                if entry.key() != "weights":
                    fill_scheme(entry)

    def init_weight(self, config_dict: ConfigDict,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """Apply the config's weight-init spec to the module, in place, and
        return its state dict.

        Handles ``weight_init`` as a single scheme, a per-layer-type scheme
        table, a ``{random: ..., weights: path}`` combination, and a bare
        checkpoint path.  The random draws come from *generator* (a fresh
        unseeded one when None)."""
        config_dict.expand()
        weight_init = config_dict.get(
            "weight_initialisation", config_dict.get("weight_init", None))
        if weight_init is None:
            return self.module.state_dict()

        # path form: the single config key IS a checkpoint path, loaded as
        # full-model weights; no random scheme applies
        path_form = None
        if isinstance(weight_init, str) and (os.path.isfile(weight_init)
                                             or weight_init.endswith(".pt")):
            path_form = weight_init
        elif isinstance(weight_init, ConfigDict) \
                and len(weight_init.keys()) == 1:
            key = str(weight_init.key())
            if os.path.isfile(key) or key.endswith(".pt"):
                path_form = key
        if path_form is not None:
            self.load_weights(path_form, strict=True)
            return self._encoder_transfer(config_dict)

        random_init = None
        if isinstance(weight_init, (tuple, list)):
            random_init = weight_init[0] if len(weight_init) == 1 \
                else ConfigDict({"otherwise": list(weight_init)})
        elif isinstance(weight_init, ConfigDict):
            if "random" in weight_init:
                random_init = weight_init["random"]
            elif "weights" not in weight_init:
                random_init = weight_init
        if isinstance(random_init, str):
            random_init = ConfigDict({random_init: {}})
        if random_init is not None:
            device = next(self.module.parameters()).device
            self.module.to("cpu")
            try:
                apply_init(self.module, random_init, generator)
            except KeyError as exc:
                warnings.warn(f"Unknown weight-init scheme: {exc}; leaving "
                              f"default initialisation.")
            finally:
                self.module.to(device)

        weights_path = None
        if isinstance(weight_init, ConfigDict) and "weights" in weight_init:
            weights_path = weight_init.trim().get("weights", None)
        strict = bool(weight_init.get("strict", True)) \
            if isinstance(weight_init, ConfigDict) else True
        if isinstance(weights_path, ConfigDict):
            # {submodule: path}: each checkpoint into the named submodule
            for attr in list(weights_path.keys()):
                self.load_weights(weights_path.get_str(attr), strict=strict,
                                  subtree=(attr,))
        elif weights_path:
            self.load_weights(weights_path, strict=strict)
        return self._encoder_transfer(config_dict)

    def _encoder_transfer(self, config_dict: ConfigDict
                          ) -> Dict[str, torch.Tensor]:
        """Graft a pretraining checkpoint's encoder (the FeedForwardModel's
        first layer) into the U-Net's ``enc``, parameters and BatchNorm
        statistics, when ``weight_init/encoder/weights`` names one.  With
        ``strict`` (the default) a missing or unexpected key fails the load;
        otherwise each is warned about and the rest is loaded.  A reference
        checkpoint (torch module names) is translated by
        ``train.torch_mapping`` first.  A failed load is never fatal: the
        encoder is left as it was, with the JAX package's message."""
        key = "weight_initialisation" \
            if "weight_initialisation" in config_dict else "weight_init"
        enc_cfg = config_dict.get(key + "/encoder")
        weights = enc_cfg.trim().get("weights", False) \
            if isinstance(enc_cfg, ConfigDict) else False
        if not weights:
            return self.module.state_dict()
        strict = bool(enc_cfg.get("strict", True))
        backup = {k: v.clone() for k, v in self.module.state_dict().items()}
        try:
            from ..train.checkpoint import is_stat, load_encoder_variables
            from ..train.torch_mapping import (looks_like_torch_encoder,
                                               translate_reference_encoder)
            params, stats = load_encoder_variables(weights)
            target = {k[len("enc."):]: v
                      for k, v in self.module.state_dict().items()
                      if k.startswith("enc.")}
            if not target:
                raise KeyError("model has no encoder subtree to load into")

            def warn(missing, unexpected):
                if strict and (missing or unexpected):
                    raise KeyError(
                        f"State mismatch loading encoder {weights}: missing "
                        f"{missing[:5]}, unexpected {unexpected[:5]}")
                if missing:
                    warnings.warn(f"Missing keys in encoder checkpoint "
                                  f"{weights}: {missing[:8]}")
                if unexpected:
                    warnings.warn(f"Unexpected keys in encoder checkpoint "
                                  f"{weights}: {unexpected[:8]}")

            if looks_like_torch_encoder(params):
                translated, leftover = translate_reference_encoder(
                    {**params, **(stats or {})})
                if leftover:
                    if strict:
                        raise KeyError(f"Unmapped torch keys in {weights}: "
                                       f"{leftover[:8]}")
                    warnings.warn(f"Unmapped torch keys in {weights}: "
                                  f"{leftover[:8]} — ignored.")
                params = {k: v for k, v in translated.items()
                          if not is_stat(k)}
                stats = {k: v for k, v in translated.items() if is_stat(k)}

            # the batch count is no statistic the JAX package keeps: it
            # neither fails nor loads
            def statistics(d):
                return {k: v for k, v in (d or {}).items() if is_stat(k)
                        and not k.endswith("num_batches_tracked")}

            _graft({k: v for k, v in target.items() if not is_stat(k)},
                   params, warn)
            if stats:
                _graft(statistics(target), statistics(stats), warn)
            print(f"Successfully initialised encoder from {weights}.")
        except Exception as exc:  # noqa: BLE001 - never fatal, as in JAX
            self.module.load_state_dict(backup)
            handle_exception(
                exc, f"Could not load encoder weights from {weights}; "
                     f"leaving random initialisation.")
        return self.module.state_dict()

    def load_weights(self, path: str, strict: bool = True,
                     subtree: Tuple[str, ...] = ()
                     ) -> Dict[str, torch.Tensor]:
        """Load a ``.pt`` state dict into (a submodule of) the module.

        Parameters: with *strict*, a missing, unexpected or mis-shaped key
        raises KeyError before any parameter is written; otherwise each is
        warned about and left as initialised.
        BatchNorm statistics load alongside and are only warned about, in
        either mode: eval would otherwise normalise with the initial
        mean 0 and variance 1 unannounced."""
        from ..train.checkpoint import is_stat, load_params_file
        loaded = load_params_file(path)
        prefix = "".join(f"{part}." for part in subtree)
        target = {k[len(prefix):]: v
                  for k, v in self.module.state_dict().items()
                  if k.startswith(prefix)}
        split = lambda d, stats: {k: v for k, v in d.items()  # noqa: E731
                                  if is_stat(k) == stats}

        def warn(missing, unexpected):
            if strict:
                raise KeyError(
                    f"State mismatch loading {path}: missing "
                    f"{missing[:5]}..., unexpected {unexpected[:5]}...")
            if missing:
                warnings.warn(f"Missing keys in {path}: {missing[:8]} — "
                              f"left randomly initialised.")
            if unexpected:
                warnings.warn(f"Unexpected keys in {path}: "
                              f"{unexpected[:8]} — ignored.")

        def stats_warn(missing, unexpected):
            if missing:
                warnings.warn(f"BN running stats missing in {path}: "
                              f"{missing[:8]} — left at init statistics.")
            if unexpected:
                warnings.warn(f"Unexpected BN stats in {path}: "
                              f"{unexpected[:8]} — ignored.")

        _graft(split(target, False), split(loaded, False), warn)
        stats_target = split(target, True)
        if stats_target:
            _graft(stats_target, split(loaded, True), stats_warn)
        return self.module.state_dict()

    # ------------------------------------------------------------------
    # freezing
    # ------------------------------------------------------------------

    def freeze_and_unfreeze(self, config_dict: ConfigDict):
        """Record the frozen submodules the config names (dotted paths;
        ``encoder``/``decoder`` alias ``enc``/``dec``, ``all`` freezes
        everything).  The optimizer consumes :meth:`trainable_mask`."""
        freeze = config_dict.get_str_tuple("weight_init/freeze_weights")
        unfreeze = config_dict.get_str_tuple("weight_init/unfreeze_weights")
        alias = {"encoder": "enc", "decoder": "dec"}

        def canon(path: str) -> Tuple[str, ...]:
            parts = tuple(p for p in path.split(".") if p)
            return tuple(alias.get(p, p) for p in parts)

        frozen = set()
        for path in freeze:
            frozen.add(("__all__",) if path == "all" else canon(path))
        for path in unfreeze:
            frozen.discard(("__all__",) if path == "all" else canon(path))
        self.frozen_paths = tuple(sorted(frozen))
        return self.frozen_paths

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name -> True where the parameter is trainable."""
        def trainable(name: str) -> bool:
            path = tuple(name.split("."))
            return not any(f == ("__all__",) or path[:len(f)] == f
                           for f in self.frozen_paths)
        return {name: trainable(name)
                for name, _ in self.module.named_parameters()}

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------

    def get_num_params(self, trainable_only: bool = False) -> int:
        mask = self.trainable_mask() if trainable_only else {}
        return sum(p.numel() for name, p in self.module.named_parameters()
                   if mask.get(name, True))
