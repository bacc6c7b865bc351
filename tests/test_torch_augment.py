"""The port's on-device augmentation against the JAX package's, on the CPU:
``rotate_batch`` (bilinear and nearest, float and uint8), ``flip_batch``
and the ``make_device_augment`` chain, with the angles and flips injected
into both, within 1e-5.  JAX draws with threefry and torch with Philox, so
the chain's own draws are checked for reproducibility only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.ops import augment as jax_augment
from medsegpretrainimagenet_tpu_torch.ops import augment

TOL = 1e-5


def _images(dtype=np.float32, n=4, h=13, w=17, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, h, w, c)) * (255 if dtype == np.uint8 else 1)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("nearest", [False, True])
def test_rotate_batch_matches_jax(dtype, nearest):
    images = _images(dtype)
    angles = np.array([0.0, 33.3, -120.0, 180.0], np.float32)
    got = augment.rotate_batch(torch.from_numpy(images),
                               torch.from_numpy(angles), fill=0.25,
                               nearest=nearest).numpy()
    want = np.asarray(jax_augment.rotate_batch(
        jnp.asarray(images), jnp.asarray(angles), fill=0.25,
        nearest=nearest))
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == np.uint8:
        # rounding of values at exact halves may land either way
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_allclose(got, want, atol=TOL)


def test_flip_batch_matches_jax():
    images = _images()
    fv = np.array([True, False, True, False])
    fh = np.array([False, True, True, False])
    got = augment.flip_batch(torch.from_numpy(images), torch.from_numpy(fv),
                             torch.from_numpy(fh)).numpy()
    want = np.asarray(jax_augment.flip_batch(jnp.asarray(images),
                                             jnp.asarray(fv),
                                             jnp.asarray(fh)))
    np.testing.assert_array_equal(got, want)


def _replayed_draws(seed, n, rotation_probability, limit):
    """The chain's draws, in its order, from a generator of *seed*."""
    g = torch.Generator().manual_seed(seed)
    angles = (torch.rand((n,), generator=g) * 2 - 1) * limit
    if rotation_probability < 1.0:
        gate = torch.rand((n,), generator=g) < rotation_probability
        angles = torch.where(gate, angles, torch.zeros_like(angles))
    flip_gate = torch.rand((n,), generator=g) < 0.7
    code = torch.randint(-1, 2, (n,), generator=g)
    return (angles.numpy(), (flip_gate & (code <= 0)).numpy(),
            (flip_gate & (code != 0)).numpy())


def test_device_augment_chain_matches_jax_ops():
    """The chain equals the JAX ops composed with the same draws: the
    rotation of x (bilinear) and mask (nearest), the flip codes of
    albumentations' Flip, and the channel repeat."""
    kwargs = dict(rotation_limit=90, rotation_probability=0.6,
                  flip_vertical=True, flip_horizontal=True,
                  flip_probability=0.7, channel_repeats=3, fill=0.0,
                  mask_fill=0.0)
    chain = augment.make_device_augment(**kwargs)
    x = _images(c=1, n=6)
    mask = np.random.default_rng(1).integers(0, 2, x.shape[:3]).astype(
        np.int32)
    out = chain(torch.Generator().manual_seed(3),
                {"x": torch.from_numpy(x), "mask": torch.from_numpy(mask)})
    angles, fv, fh = _replayed_draws(3, 6, 0.6, 90)
    assert (angles == 0).any() and (angles != 0).any()
    jx = jax_augment.rotate_batch(jnp.asarray(x), jnp.asarray(angles))
    jm = jax_augment.rotate_batch(jnp.asarray(mask)[..., None],
                                  jnp.asarray(angles), nearest=True)[..., 0]
    jx = jax_augment.flip_batch(jx, jnp.asarray(fv), jnp.asarray(fh))
    jm = jax_augment.flip_batch(jm, jnp.asarray(fv), jnp.asarray(fh))
    jx = jax_augment.repeat_channels(jx, 3)
    assert out["x"].shape == (6, 13, 17, 3)
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(jx), atol=TOL)
    assert (out["mask"].numpy() == np.asarray(jm)).mean() >= 0.999
    assert out["mask"].dtype == torch.int32


def test_device_augment_draws_are_seeded():
    chain = augment.make_device_augment(rotation_limit=45,
                                        flip_vertical=True)
    x = torch.from_numpy(_images(n=5))
    runs = [chain(torch.Generator().manual_seed(s), {"x": x})["x"]
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
