"""Learning-rate schedule zoo as pure ``step -> lr`` functions: the port of
``optim/schedules.py``.

Constant, sequential, constant-warmup, linear, linear-warmup, step, poly,
cosine, exponential and gaussian schedules, each with an
``iteration_unit`` of ``'batch'`` or ``'epoch'`` and ``'auto'`` horizons
from ``num_epochs`` x ``batches_per_epoch``.  Every schedule is a function
of the global optimizer-step index (a Python int) returning a Python float
on the host: the train step sets it into the optimizer's param groups
before each update, which needs no device work and no host sync, and
resume reduces to restoring the step counter.  ``torch.optim.lr_scheduler``
is not used.  Unit conversion happens once at build time: an epoch-unit
schedule sees ``step // batches_per_epoch``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..config import ConfigDict, register

__all__ = ["ScheduleSpec", "build_schedule", "fill_schedule_spec",
           "DEFAULT_BASE_LR"]

DEFAULT_BASE_LR = 0.01


@dataclass
class ScheduleSpec:
    """A schedule in its own iteration unit, plus wiring metadata."""

    fn: Callable[[int], float]  # unit-step -> lr
    unit: str = "epoch"         # 'batch' | 'epoch'
    base: float = DEFAULT_BASE_LR

    def global_fn(self, batches_per_epoch: int) -> Callable[[int], float]:
        """Schedule of the *global optimizer-step* counter."""
        if self.unit == "batch":
            return self.fn
        bpe = max(int(batches_per_epoch), 1)
        return lambda step: self.fn(step // bpe)


def _horizon(total, unit: str, num_epochs: Optional[int],
             batches_per_epoch: int, what: str) -> int:
    if isinstance(total, ConfigDict):
        total = total.key()
    if total == "auto":
        if not isinstance(num_epochs, int):
            raise TypeError(f"{what}: 'auto' horizon needs an integer "
                            f"number of epochs, got {num_epochs!r}")
        return num_epochs * batches_per_epoch if unit == "batch" \
            else num_epochs
    if not isinstance(total, int):
        raise TypeError(f"{what}: horizon must be int or 'auto', "
                        f"got {total!r}")
    return total


def _unit(params: ConfigDict, default: str = "epoch") -> str:
    unit = params.get("iteration_unit", default)
    if isinstance(unit, ConfigDict):
        unit = unit.key()
    return unit or default


def _get(params: ConfigDict, key: str, default):
    value = params.get(key, default)
    if isinstance(value, ConfigDict):
        value = value.key()
    return value


# ---------------------------------------------------------------------------
# schedule factories: (params, base, unit, num_epochs, batches_per_epoch)
#                      -> fn(unit_step) -> lr
# ---------------------------------------------------------------------------

def _constant(params, base, unit, num_epochs, bpe):
    return lambda step: float(base)


def _linear(params, base, unit, num_epochs, bpe):
    start = float(_get(params, "start_factor", 1.0e-6))
    end = float(_get(params, "end_factor", 1.0))
    total = _horizon(_get(params, "total_iters", "auto"), unit, num_epochs,
                     bpe, "LinearLR")

    def fn(step):
        frac = min(max(step / max(total, 1), 0.0), 1.0)
        return base * (start + (end - start) * frac)
    return fn


def _poly(params, base, unit, num_epochs, bpe):
    exponent = float(_get(params, "exponent", 0.9))
    minimum = _get(params, "minimum", None) or 0.0
    last_epoch = int(_get(params, "last_epoch", -1))
    total = _horizon(_get(params, "number_of_iterations", "auto"), unit,
                     num_epochs, bpe, "PolyLearningRateDecay")

    def fn(step):
        # the reference's hand-rolled step() reads its counter (starting
        # at last_epoch, default -1) before incrementing it, so the lr of
        # training step s is (1 - (s - 2)/N)^gamma, with a (1 + 1/N)^gamma
        # bump at s == 1; the published results were trained on it
        i = step + last_epoch - 1
        frac = 1.0 if step == 0 else max(1.0 - i / max(total, 1), 0.0)
        return max(base * frac ** exponent, minimum)
    return fn


def _cosine(params, base, unit, num_epochs, bpe):
    eta_min = float(_get(params, "eta_min", 0.0))
    t_max = _horizon(_get(params, "T_max", "auto"), unit, num_epochs, bpe,
                     "CosineAnnealingLR")

    def fn(step):
        # no clamp at T_max: torch's closed form is periodic, past T_max
        # the lr climbs back toward base
        frac = step / max(t_max, 1)
        return eta_min + (base - eta_min) * 0.5 * (1 + math.cos(math.pi
                                                                * frac))
    return fn


def _exponential(params, base, unit, num_epochs, bpe):
    gamma = _get(params, "gamma", "auto")
    if gamma == "auto":
        min_scale = float(_get(params, "min_scale", 0.001))
        total = _horizon("auto", unit, num_epochs, bpe, "ExponentialLR")
        gamma = min_scale ** (1.0 / max(total, 1))
    gamma = float(gamma)
    return lambda step: base * gamma ** step


def _gaussian(params, base, unit, num_epochs, bpe):
    min_scale = float(_get(params, "min_scale", 0.001))
    total = _horizon(_get(params, "number_of_iterations", "auto"), unit,
                     num_epochs, bpe, "GaussianLRDecay")
    gamma = min_scale ** (1.0 / max(total, 1) ** 2)

    def fn(step):
        return base * gamma ** (min(step, total) ** 2)
    return fn


def _step_lr(params, base, unit, num_epochs, bpe):
    table = params.get("learning_rates_dict", ConfigDict())
    if isinstance(table, ConfigDict):
        table = {int(k): float(v if not isinstance(v, ConfigDict) else v.key())
                 for k, v in table.to_dict().items()}
    # a 0 (or negative) milestone is dead in the reference: its counter is
    # incremented before the membership check, so it never equals 0
    milestones = sorted(m for m in table if m >= 1)
    values = [float(base)] + [table[m] for m in milestones]
    return lambda step: values[sum(step >= m for m in milestones)]


def _sub_schedule(cfg, base, parent_unit, num_epochs, bpe,
                  config_unit: bool = True) -> Callable:
    """A nested schedule: stepped at the parent's cadence, but its 'auto'
    horizon resolves in the sub-scheduler's own iteration unit (its config
    value, or its class default).  With ``config_unit=False`` the sub
    config's explicit unit is ignored and the class default used (the
    reference's SequentialLR drops ``iteration_unit`` from its sub
    dicts)."""
    if cfg is None:
        return _constant(ConfigDict(), base, parent_unit, num_epochs, bpe)
    if isinstance(cfg, str):
        cfg = ConfigDict({cfg: {}})
    name, params = cfg.item()
    if not isinstance(params, ConfigDict):
        params = ConfigDict()
    canon = _canon(name)
    factory = _FACTORIES.get(canon)
    if factory is None:
        raise KeyError(f"Unknown scheduler {name!r}")
    sub_base = float(_get(params, "base", base))
    default_unit = _DEFAULT_UNITS.get(canon, "epoch")
    sub_unit = _unit(params, default_unit) if config_unit else default_unit
    return factory(params, sub_base, sub_unit, num_epochs, bpe)


def _main_epochs(num_epochs, length, unit, bpe):
    if num_epochs is None:
        return None
    return num_epochs - (length if unit == "epoch" else length // max(bpe, 1))


def _warmup(params, base, unit, num_epochs, bpe):
    """Constant warmup lr, then base lr under the main schedule."""
    # an omitted (or empty) 'warmup' key means warmup enabled with the
    # reference defaults {learning_rate: 0.1, length: 1}; only an explicit
    # ``warmup: false``/null disables it
    warmup = params.get("warmup") if params.has("warmup") else ConfigDict()
    if warmup is None or warmup is False:
        length, warmup_lr = 0, base
    else:
        length = int(_get(warmup, "length", 1))
        warmup_lr = float(_get(warmup, "learning_rate", 0.1))
    main = _sub_schedule(params.get("main_scheduler", None), base, unit,
                         _main_epochs(num_epochs, length, unit, bpe), bpe)

    def fn(step):
        # the reference flips out of warmup only when last_step == length
        # and advances the main schedule in the same call: the warmup lr
        # holds for length + 1 units and the main schedule starts at f(1)
        return warmup_lr if step <= length else main(step - length)
    return fn


def _linear_warmup(params, base, unit, num_epochs, bpe):
    length = int(_get(params, "warmup_length", 20))
    ramp = _linear(ConfigDict({"total_iters": length}), base, unit,
                   num_epochs, bpe)
    main = _sub_schedule(params.get("main_scheduler", None), base, unit,
                         _main_epochs(num_epochs, length, unit, bpe), bpe)
    return lambda step: ramp(step) if step < length else main(step - length)


def _sequential(params, base, unit, num_epochs, bpe):
    """Chain schedules switching at milestones (restarting each segment)."""
    schedulers = params.get("schedulers", ())
    if isinstance(schedulers, ConfigDict):
        schedulers = (schedulers,)
    milestones = params.get("milestones", ())
    if not isinstance(milestones, (tuple, list)):
        milestones = (milestones,)
    milestones = [int(m) for m in milestones]
    m_unit = _get(params, "milestones_unit", "epoch")
    if m_unit not in ("batch", "epoch"):
        raise ValueError(f"milestones_unit must be batch/epoch, got {m_unit}")

    # milestones in the schedule's own unit
    if m_unit == "epoch":
        epoch_milestones = milestones
        if unit == "batch":
            milestones = [m * bpe for m in milestones]
    else:
        epoch_milestones = [m // max(bpe, 1) for m in milestones]

    if len(schedulers) != len(milestones) + 1:
        # torch's SequentialLR raises the same way at construction
        raise ValueError(
            f"sequential schedule needs one more scheduler than "
            f"milestones, got {len(schedulers)} schedulers and "
            f"{len(milestones)} milestones")

    default_end = (epoch_milestones[-1] + 1) if epoch_milestones else 1
    end_epochs = num_epochs or default_end
    starts = [0, *epoch_milestones]
    ends = [*epoch_milestones, end_epochs]
    fns = [_sub_schedule(cfg, base, unit, end - start, bpe,
                         config_unit=False)
           for cfg, start, end in zip(schedulers, starts, ends)]
    offsets = [0, *milestones]

    def fn(step):
        idx = sum(step >= m for m in milestones)
        return fns[idx](max(step - offsets[idx], 0))
    return fn


def _canon(name: str) -> str:
    return name.rsplit(".", 1)[-1]


_FACTORIES = {
    "constant": _constant,
    "ConstantLR": _constant,
    "LinearLR": _linear,
    "PolyLearningRateDecay": _poly,
    "CosineAnnealingLR": _cosine,
    "ExponentialLR": _exponential,
    "GaussianLRDecay": _gaussian,
    "StepLearningRateScheduler": _step_lr,
    "WarmUpScheduler": _warmup,
    "LinearWarmupScheduler": _linear_warmup,
    "SequentialLR": _sequential,
}

#: default-iteration-unit overrides (reference class defaults)
_DEFAULT_UNITS = {
    "LinearLR": "batch",
    "CosineAnnealingLR": "batch",
    "ExponentialLR": "batch",
    "GaussianLRDecay": "batch",
    "SequentialLR": "batch",
    "PolyLearningRateDecay": "epoch",
}


def fill_schedule_spec(lr_cfg: ConfigDict) -> None:
    """Inject schedule defaults (the fill_kwargs analog for schedulers)."""
    if not isinstance(lr_cfg, ConfigDict) or len(lr_cfg) != 1:
        return
    name, params = lr_cfg.item()
    if not isinstance(params, ConfigDict):
        return
    canon = _canon(name)
    params.get_or_update("iteration_unit",
                         _DEFAULT_UNITS.get(canon, "epoch"))
    if canon == "ExponentialLR" and _get(params, "gamma", "auto") == "auto":
        params.get_or_update("min_scale", 0.001)
    if canon == "WarmUpScheduler":
        # a missing warmup key defaults to enabled, {learning_rate: 0.1,
        # length: 1}
        if not params.has("warmup"):
            params["warmup"] = {"learning_rate": 0.1, "length": 1}
        warmup = params["warmup"]
        if isinstance(warmup, ConfigDict):
            warmup.fill_with_defaults({"learning_rate": 0.1, "length": 1})


def build_schedule(lr_cfg: Any, num_epochs: Optional[int] = None,
                   batches_per_epoch: int = 1) -> ScheduleSpec:
    """Build a ScheduleSpec from a ``{scheduler_name: params}`` config (the
    optimizer's ``learning_rate`` entry; ``base`` is the initial lr)."""
    if lr_cfg is None:
        lr_cfg = ConfigDict({"constant": {"base": DEFAULT_BASE_LR}})
    if isinstance(lr_cfg, (int, float)):
        return ScheduleSpec(fn=_constant(ConfigDict(), float(lr_cfg),
                                         "epoch", num_epochs,
                                         batches_per_epoch),
                            unit="epoch", base=float(lr_cfg))
    if isinstance(lr_cfg, str):
        lr_cfg = ConfigDict({lr_cfg: {}})
    name, params = lr_cfg.item()
    if not isinstance(params, ConfigDict):
        params = ConfigDict()
    canon = _canon(name)
    factory = _FACTORIES.get(canon)
    if factory is None:
        raise KeyError(f"Unknown scheduler {name!r} (known: "
                       f"{sorted(_FACTORIES)})")
    fill_schedule_spec(lr_cfg)
    base = float(_get(params, "base", DEFAULT_BASE_LR))
    unit = _unit(params, _DEFAULT_UNITS.get(canon, "epoch"))
    fn = factory(params, base, unit, num_epochs, batches_per_epoch)
    return ScheduleSpec(fn=fn, unit=unit, base=base)


# scheduler names resolve through the registry too
for _alias in ("optim.scheduler.ConstantLR", "optim.scheduler.SequentialLR",
               "optim.scheduler.WarmUpScheduler", "optim.scheduler.LinearLR",
               "optim.scheduler.LinearWarmupScheduler",
               "optim.scheduler.StepLearningRateScheduler",
               "optim.scheduler.PolyLearningRateDecay",
               "optim.scheduler.CosineAnnealingLR",
               "optim.scheduler.ExponentialLR",
               "optim.scheduler.GaussianLRDecay",
               "torch.optim.lr_scheduler.CosineAnnealingLR"):
    register(_alias)(build_schedule)
