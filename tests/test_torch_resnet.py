"""The port's ``DeepResNet`` held against the JAX package's on the CPU.

The same weights (the JAX variables transplanted by
``transfer.state_dict_from_jax``, which also proves that the port's module
names are the flax paths) and the same numpy inputs give the same skips
and final output within 1e-5: v1 and v2, basic and bottleneck blocks, with
and without the head, with stochastic depth at eval (the classification
DropPath scales by the keep probability there) and with the stem sized
for a 1-channel probe, as flax sizes it from its init sample.  The
registry resolves every name of the JAX package's registry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.models import resnet as jax_resnet
from medsegpretrainimagenet_tpu_torch.config import registry
from medsegpretrainimagenet_tpu_torch.models import resnet

from torch_port_helpers import transplant

TOL = 1e-5
#: a small ResNet: two stages of widths 1 and 2
SMALL = {"channel_sizes": (16, 32), "widths": (1, 2),
         "base_channel_size": 8, "output_size": 5}


def _jax_resnet(in_channels, seed=0, size=32, batch=2, **kwargs):
    """A JAX DeepResNet initialised on an input of *in_channels*, its
    variables with non-trivial BatchNorm statistics, and that input."""
    module = jax_resnet.DeepResNet(**{**SMALL, **kwargs})
    x = np.random.default_rng(seed).random(
        (batch, size, size, in_channels)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.key(seed), jnp.asarray(x)))
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables.get("batch_stats", {}))
    return module, {**variables, "batch_stats": stats}, x


def _hold(module, variables, x, in_channels, **kwargs):
    want_final, want_skips = module.apply(
        variables, jnp.asarray(x), train=False, return_skip_vals=True)
    port = transplant(variables, resnet.DeepResNet(
        in_channels=in_channels, **{**SMALL, **kwargs}))
    with torch.no_grad():
        final, skips = port(torch.from_numpy(x), return_skip_vals=True)
    assert len(skips) == len(want_skips)
    for got, want in zip([*skips, final], [*want_skips, want_final]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    return port


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("bottleneck", [True, False])
@pytest.mark.parametrize("head", [False, True])
def test_deep_resnet_matches_jax(version, bottleneck, head):
    module, variables, x = _jax_resnet(3, version=version,
                                       bottleneck=bottleneck, head=head)
    _hold(module, variables, x, 3, version=version, bottleneck=bottleneck,
          head=head)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_stochastic_depth_scales_at_eval_as_jax(version):
    """Stochastic depth above zero: at eval each block's branch is scaled
    by its keep probability (linearly spaced up to the rate)."""
    kwargs = dict(version=version, stochastic_depth_rate=0.3)
    module, variables, x = _jax_resnet(3, seed=2, **kwargs)
    port = _hold(module, variables, x, 3, **kwargs)
    probs = [b.drop_probability for level in port.levels for b in level]
    np.testing.assert_allclose(probs, np.linspace(0, 0.3, 3))


def test_stem_built_from_a_one_channel_probe():
    """Flax sizes the stem from the init sample: a 1-channel probe gives a
    (7, 7, 1, C) kernel, and the port built with ``in_channels=1`` takes
    the same weights."""
    module, variables, x = _jax_resnet(1, seed=3, bias=False)
    assert variables["params"]["stem_conv"]["kernel"].shape == (7, 7, 1, 8)
    assert "bias" not in variables["params"]["stem_conv"]
    port = _hold(module, variables, x, 1, bias=False)
    assert tuple(port.stem_conv.weight.shape) == (8, 1, 7, 7)


def test_drop_path_keeps_or_zeroes_without_rescaling():
    """The classification DropPath in training: each sample's branch kept
    as it is or zeroed; at eval the keep probability scales it."""
    x = torch.rand(64, 3, 3, 2) + 1.0
    y = resnet.drop_path(x, 0.5, training=True,
                         generator=torch.Generator().manual_seed(0))
    kept = (y == x).flatten(1).all(1)
    dropped = (y == 0).flatten(1).all(1)
    assert bool((kept | dropped).all()) and 0 < int(kept.sum()) < 64
    assert torch.equal(resnet.drop_path(x, 0.25, training=False,
                                        generator=None),
                       x * torch.tensor(0.75))
    assert resnet.drop_path(x, 0.0, training=True, generator=None) is x


@pytest.mark.parametrize("downsample", [False, True])
@pytest.mark.parametrize("out_channels", [4, 7])
def test_zero_fill_shortcut_matches_jax(downsample, out_channels):
    x = np.random.default_rng(4).random((2, 5, 5, 4)).astype(np.float32)
    want = jax_resnet._zero_fill_shortcut(jnp.asarray(x), out_channels,
                                          downsample)
    got = resnet._zero_fill_shortcut(torch.from_numpy(x), out_channels,
                                     downsample)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        resnet._zero_fill_shortcut(torch.from_numpy(x), 2, downsample)


def test_registry_names():
    for name in ("classification.models.DeepResNet", "deep_resnet",
                 "resnet"):
        assert registry.resolve(name) is resnet.DeepResNet
    with pytest.raises(ValueError):
        resnet.DeepResNet(version="v3")
    with pytest.raises(ValueError):
        resnet.DeepResNet(widths=(1,), channel_sizes=(8, 16))
    assert resnet.DeepResNet(version=2, **SMALL).version == "v2"


def test_every_jax_component_name_resolves_in_the_port():
    """Each name of the JAX registry is a component of the port: since the
    residual block zoo, IDRiD and ``MixedDataset`` were ported none is a
    placeholder that raises NotImplementedError, and none is an unknown
    name.  Names that other test files register in the JAX registry (the
    toy readers of ``test_readers.py`` and ``test_torch_mixed.py``, when
    pytest-xdist runs such a file earlier in the same worker) are not the
    JAX package's components and are left out."""
    names = [name for name in jax_registry.names()
             if jax_registry.resolve(name).__module__.startswith(
                 "medsegpretrainimagenet_tpu.")]
    assert len(names) >= 126
    for name in names:
        constructor = registry.resolve(name)
        assert not constructor.__name__.startswith("NotPorted["), name
        assert constructor.__module__.startswith(
            "medsegpretrainimagenet_tpu_torch"), name
