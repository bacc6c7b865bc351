"""Component registry: config names -> the port's constructors.

The port's own copy of ``medsegpretrainimagenet_tpu/config/registry.py``,
with its own component table: every buildable component of the port
registers itself under the same dotted names the JAX registry uses, so a
config names the same components in both packages.  The table is filled by
importing the port's own modules.  Unknown names fail fast with close-match
suggestions.

Constructors may carry two optional class attributes that drive config
handling, mirroring the reference protocol (SURVEY.md §2.1):

* ``PARAMS``: dict of parameter specs ``name -> {'default': v,
  'argument name': a}`` (or a plain default).  Used both to fill a config
  with defaults and to translate config keys to constructor kwargs.
* ``fill_kwargs(config_dict)``: classmethod hook for computed defaults.
"""
from __future__ import annotations

import difflib
import inspect
import threading
from typing import Any, Callable, Optional, Union

from .config_dict import ConfigDict

__all__ = ["register", "resolve", "build", "fill_spec", "get_kwargs",
           "accepts_kwarg", "RegistryError"]


class RegistryError(KeyError):
    pass


_COMPONENTS: dict = {}
_POPULATED = False
_LOCK = threading.Lock()

#: modules whose import registers the port's components
_COMPONENT_MODULES = (
    "medsegpretrainimagenet_tpu_torch.models",
    "medsegpretrainimagenet_tpu_torch.losses",
    "medsegpretrainimagenet_tpu_torch.optim",
    "medsegpretrainimagenet_tpu_torch.data",
)


def register(*names: str) -> Callable:
    """Class/function decorator adding the object under each given name."""
    def decorate(obj):
        for name in names:
            if name in _COMPONENTS and _COMPONENTS[name] is not obj:
                raise RegistryError(f"duplicate registration for {name!r}")
            _COMPONENTS[name] = obj
        return obj
    return decorate


def _populate():
    global _POPULATED
    with _LOCK:
        if _POPULATED:
            return
        import importlib
        for module in _COMPONENT_MODULES:
            importlib.import_module(module)
        _POPULATED = True


def resolve(name: Union[str, ConfigDict]) -> Callable:
    """Look up a component constructor by its registered name."""
    if isinstance(name, ConfigDict):
        name = name.key()
    if name not in _COMPONENTS:
        _populate()
    try:
        return _COMPONENTS[name]
    except KeyError:
        close = difflib.get_close_matches(name, _COMPONENTS, n=3, cutoff=0.5)
        hint = f" Did you mean: {', '.join(close)}?" if close else ""
        raise RegistryError(
            f"Unknown component {name!r}.{hint} "
            f"(register it with medsegpretrainimagenet_tpu_torch.config."
            f"registry.register)") from None


def _name_and_params(config_dict: ConfigDict, key: Optional[str] = None):
    """Split ``{name: params}`` (possibly under *key*) into pieces."""
    value = config_dict[key]
    if isinstance(value, str):
        return value, ConfigDict()
    name, params = value.item()
    if not isinstance(params, ConfigDict):
        params = ConfigDict()
    return name, params


def accepts_kwarg(fn: Callable, kwarg: str) -> bool:
    params = inspect.signature(fn).parameters
    return kwarg in params or any(
        p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values())


#: constructor parameters never treated as config hyperparameters
_NON_CONFIG_PARAMS = frozenset({"args", "kwargs"})


def _signature_defaults(constructor: Callable) -> dict:
    try:
        sig = inspect.signature(constructor)
    except (TypeError, ValueError):
        return {}
    return {k: p.default for k, p in sig.parameters.items()
            if p.default is not inspect.Parameter.empty
            and p.default is not None
            and not isinstance(p.default, (type(...),))
            and k not in _NON_CONFIG_PARAMS}


def fill_spec(config_dict: ConfigDict, key: Optional[str] = None,
              name: Optional[str] = None,
              fill_with_init_params: bool = True) -> Optional[ConfigDict]:
    """Inject a component's default hyperparameters into its config.

    ``config_dict[key]`` is expected to look like ``{name: {params...}}``
    (after :meth:`ConfigDict.expand`).  Defaults come from the constructor's
    ``PARAMS`` table, falling back to its signature defaults; a
    ``fill_kwargs`` hook runs last for computed defaults.
    """
    if not isinstance(config_dict, ConfigDict):
        return None
    if name is None:
        name, params = _name_and_params(config_dict, key)
    else:
        params = config_dict
    constructor = resolve(name)
    spec = getattr(constructor, "PARAMS", None)
    if spec is None:
        spec = _signature_defaults(constructor) if fill_with_init_params else {}
    params.fill_with_defaults(spec)
    hook = getattr(constructor, "fill_kwargs", None)
    if hook is not None:
        hook(params)
    return config_dict


def get_kwargs(constructor: Callable,
               config_dict: Union[ConfigDict, dict, None] = None) -> dict:
    """Constructor kwargs from a config, honouring PARAMS argument renames."""
    if config_dict is None:
        config_dict = {}
    spec = getattr(constructor, "PARAMS", None)
    if spec is not None:
        kwargs = {}
        for name, entry in spec.items():
            arg, default = name, entry
            if isinstance(entry, dict):
                arg = entry.get("argument name",
                                entry.get("argument_name", name))
                default = entry.get("default", entry)
            if isinstance(config_dict, ConfigDict):
                kwargs[arg] = config_dict.get(name, default)
            else:
                kwargs[arg] = config_dict.get(name, default) \
                    if isinstance(config_dict, dict) else default
        return kwargs
    if isinstance(config_dict, ConfigDict):
        return config_dict.trim().to_dict(lists_to_tuples=True)
    return dict(config_dict)


def build(config_dict: Union[ConfigDict, str], key: Optional[str] = None,
          name: Optional[str] = None, wrapper: Optional[type] = None,
          convert_to_kwargs: bool = False, filter_kwargs: bool = False,
          *args: Any, **kwargs: Any):
    """Instantiate a component described by ``{name: params}``.

    * With *wrapper*, the constructor (unless already a subclass of the
      wrapper) is handed to ``wrapper(constructor, params, ...)`` — the
      domain wrappers (Model / Dataset / Loss / ...) own kwargs handling.
    * With ``convert_to_kwargs``, params are translated via
      :func:`get_kwargs` and splatted into the constructor.
    * Otherwise the constructor receives the params ConfigDict positionally.
    """
    if not isinstance(config_dict, ConfigDict):
        config_dict = ConfigDict({config_dict: {}})
    if name is None:
        name, params = _name_and_params(config_dict, key)
    else:
        params = config_dict
    constructor = resolve(name)

    if filter_kwargs:
        kwargs = {k: v for k, v in kwargs.items()
                  if accepts_kwarg(constructor, k)}

    if wrapper is not None and wrapper not in getattr(constructor, "__mro__", ()):
        return wrapper(constructor, params, *args, **kwargs)
    if convert_to_kwargs:
        return constructor(*args, **kwargs, **get_kwargs(constructor, params))
    return constructor(params, *args, **kwargs)
