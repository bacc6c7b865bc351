"""Config kernel: ConfigDict, the component registry, the experiment-grid
parser and the experiment defaults."""
from . import registry
from .config_dict import ConfigDict
from .defaults import default_experiment_config, default_model_eval
from .grid import dump_yaml, expand_grid, parse
from .registry import build, fill_spec, get_kwargs, register, resolve

__all__ = ["ConfigDict", "registry", "register", "resolve", "build",
           "fill_spec", "get_kwargs", "expand_grid", "parse", "dump_yaml",
           "default_experiment_config", "default_model_eval"]
