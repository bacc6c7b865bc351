"""The port's schedules and optimizers against the JAX package's.

Every schedule's lr sequence equals JAX's to float32 rounding (JAX computes
in float32, the port in Python floats on the host): rtol 1e-6, about eight
float32 steps, and atol 1e-7 x base where a value cancels towards 0.  Three
updates of every optimizer (SGD plain, momentum, nesterov, dampening;
Adam, AdamW, coupled and decoupled decay, amsgrad; a frozen parameter)
equal optax's within 1e-6, with the lr of step k read from the schedule at
k as optax's count reads it."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.optim import Optimizer as JaxOptimizer
from medsegpretrainimagenet_tpu.optim.schedules import \
    build_schedule as jax_build_schedule
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.optim import Optimizer, build_schedule

TOL = 1e-6

#: (config, num_epochs, batches_per_epoch, steps): the zoo, both units,
#: 'auto' horizons, nesting, warmups and milestones (tests/test_optim.py's
#: cases and the shipped configs' shapes)
SCHEDULES = {
    "constant": ({"constant": {"base": 0.3}}, 2, 3, 8),
    "poly_batch": ({"optim.scheduler.PolyLearningRateDecay": {
        "base": 1e-3, "exponent": 0.9, "iteration_unit": "batch",
        "number_of_iterations": "auto"}}, 2, 5, 12),
    "poly_epoch_min": ({"optim.scheduler.PolyLearningRateDecay": {
        "base": 0.01, "exponent": 0.9, "minimum": 1e-4}}, 4, 3, 15),
    "cosine": ({"optim.scheduler.CosineAnnealingLR": {
        "base": 1.0, "eta_min": 0.1, "T_max": 10}}, None, 1, 25),
    "cosine_auto_epoch": ({"optim.scheduler.CosineAnnealingLR": {
        "base": 0.004, "T_max": "auto", "iteration_unit": "epoch"}},
        5, 4, 22),
    "linear": ({"optim.scheduler.LinearLR": {
        "base": 2.0, "start_factor": 0.5, "end_factor": 1.0,
        "total_iters": 4}}, None, 1, 7),
    "exponential_auto": ({"optim.scheduler.ExponentialLR": {
        "base": 1.0, "gamma": "auto", "min_scale": 0.01,
        "iteration_unit": "epoch"}}, 10, 2, 22),
    "gaussian": ({"optim.scheduler.GaussianLRDecay": {
        "base": 1.0, "min_scale": 0.001, "number_of_iterations": 10,
        "iteration_unit": "batch"}}, None, 1, 13),
    "step": ({"optim.scheduler.StepLearningRateScheduler": {
        "base": 0.1, "learning_rates_dict": {0: 0.5, 3: 0.01, 6: 0.001},
        "iteration_unit": "epoch"}}, None, 4, 30),
    "sequential": ({"optim.scheduler.SequentialLR": {
        "base": 0.004,
        "schedulers": ({"optim.scheduler.LinearLR": {
            "start_factor": 1.0e-6, "end_factor": 1.0}},
            {"optim.scheduler.CosineAnnealingLR": {"eta_min": 1.0e-6}}),
        "milestones": (2,), "milestones_unit": "epoch",
        "iteration_unit": "batch"}}, 10, 4, 41),
    "warmup": ({"optim.scheduler.WarmUpScheduler": {
        "base": 0.01, "warmup": {"learning_rate": 0.1, "length": 3},
        "main_scheduler": None, "iteration_unit": "epoch"}}, 10, 1, 8),
    "warmup_nested_cosine": ({"optim.scheduler.WarmUpScheduler": {
        "base": 0.01, "warmup": {"learning_rate": 0.1, "length": 1},
        "main_scheduler": {"optim.scheduler.CosineAnnealingLR": {
            "T_max": "auto", "eta_min": 0.0}},
        "iteration_unit": "epoch"}}, 10, 5, 50),
    "warmup_default": ({"optim.scheduler.WarmUpScheduler": {
        "base": 0.01, "iteration_unit": "batch"}}, 3, 2, 6),
    "linear_warmup_poly": ({"optim.scheduler.LinearWarmupScheduler": {
        "base": 0.05, "warmup_length": 4,
        "main_scheduler": {"optim.scheduler.PolyLearningRateDecay": {
            "exponent": 0.9, "number_of_iterations": "auto"}},
        "iteration_unit": "batch"}}, 3, 4, 12),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    cfg, epochs, bpe, steps = SCHEDULES[name]
    spec = build_schedule(ConfigDict(cfg), num_epochs=epochs,
                          batches_per_epoch=bpe)
    ref = jax_build_schedule(JaxConfigDict(cfg), num_epochs=epochs,
                             batches_per_epoch=bpe)
    assert spec.unit == ref.unit and spec.base == ref.base
    fn, ref_fn = spec.global_fn(bpe), ref.global_fn(bpe)
    got = np.array([fn(s) for s in range(steps)])
    want = np.array([float(ref_fn(jnp.asarray(s))) for s in range(steps)])
    assert all(isinstance(fn(s), float) for s in range(steps))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7 * spec.base)


#: optimizer configs; the lr schedule is added in the test
OPTIMIZERS = {
    "sgd_default": {"sgd": {"weight decay": 0.01}},
    "sgd_nesterov": {"sgd": {"nesterov momentum": True}},
    "sgd_dampening": {"sgd": {"momentum dampening": 0.3}},
    "sgd_nesterov_dampening": {"sgd": {"nesterov momentum": True,
                                       "momentum dampening": 0.3}},
    "torch_sgd_plain": {"torch.optim.SGD": {"weight_decay": 0.01}},
    "adam": {"adam": {}},
    "adam_coupled_decay": {"adam": {"weight decay": 0.05}},
    "adam_decoupled_decay": {"adam": {"weight decay": 0.05,
                                      "decoupled weight decay": True}},
    "adamw": {"torch.optim.AdamW": {}},
    "adam_amsgrad": {"adam": {"amsgrad": True}},
    "torch_adam_amsgrad": {"torch.optim.Adam": {"amsgrad": True,
                                                "weight_decay": 0.01}},
    "adamw_amsgrad": {"torch.optim.AdamW": {"amsgrad": True}},
}


class _Params(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))
        self.b = torch.nn.Parameter(torch.tensor(b))


def _updates(cfg, mask=None):
    """Three updates of the port's and optax's optimizer from the same
    parameters and gradients (shrinking, so amsgrad's maximum holds an
    older moment), under a poly schedule; returns both parameter sets."""
    name = next(iter(cfg))
    cfg = {name: dict(cfg[name], learning_rate={
        "optim.scheduler.PolyLearningRateDecay": {
            "base": 0.05, "exponent": 0.9, "iteration_unit": "batch",
            "number_of_iterations": "auto"}})}
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
              for k, v in params.items()} for scale in (1.0, 0.1, 0.5)]

    opt = Optimizer(ConfigDict(cfg), num_epochs=1, batches_per_epoch=3,
                    trainable_mask=mask)
    module = _Params(params["w"], params["b"])
    torch_opt = opt.init(module)
    for step, g in enumerate(grads):
        for key, value in g.items():
            getattr(module, key).grad = torch.tensor(value)
        opt.set_lr(torch_opt, step)
        torch_opt.step()

    ref = JaxOptimizer(JaxConfigDict(cfg), num_epochs=1, batches_per_epoch=3,
                       trainable_mask=mask)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = ref.tx.init(jparams)
    for g in grads:
        updates, state = ref.tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    return params, module, jparams


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    _, module, jparams = _updates(OPTIMIZERS[name])
    for key in ("w", "b"):
        np.testing.assert_allclose(getattr(module, key).detach().numpy(),
                                   np.asarray(jparams[key]), rtol=TOL,
                                   atol=TOL, err_msg=key)


def test_frozen_parameters_get_no_update():
    """A trainable mask freezes 'w': optax sets its update to zero, the
    port leaves it out of the param groups (no decay, no momentum)."""
    params, module, jparams = _updates(
        {"sgd": {"weight decay": 0.01}}, mask={"w": False, "b": True})
    np.testing.assert_array_equal(module.w.detach().numpy(), params["w"])
    np.testing.assert_array_equal(np.asarray(jparams["w"]), params["w"])
    np.testing.assert_allclose(module.b.detach().numpy(),
                               np.asarray(jparams["b"]), rtol=TOL, atol=TOL)
    assert not np.allclose(np.asarray(jparams["b"]), params["b"])


def test_optimizer_defaults_and_registry():
    """``sgd`` defaults to momentum 0.9 (torch.optim.SGD's alias to 0), the
    lr defaults to a constant 0.01, and every name resolves."""
    sgd = Optimizer(ConfigDict({"sgd": {}}))
    assert sgd.kwargs["momentum"] == 0.9 and sgd.lr_at(5) == 0.01
    assert Optimizer(ConfigDict({"torch.optim.SGD": {}})) \
        .kwargs["momentum"] == 0.0
    torch_opt = sgd.init(_Params(np.zeros(2, np.float32),
                                 np.zeros(1, np.float32)))
    assert isinstance(torch_opt, torch.optim.SGD)
    assert torch_opt.param_groups[0]["momentum"] == 0.9
    for name in ("sgd", "adam", "torch.optim.AdamW", "torch.optim.Adam",
                 "torch.optim.SGD", "optim.scheduler.PolyLearningRateDecay"):
        registry.resolve(name)
