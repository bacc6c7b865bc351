"""The port's on-device augmentation against the JAX package's, on the CPU:
``rotate_batch`` (bilinear and nearest, float and uint8), ``flip_batch``
and the ``make_device_augment`` chain, with the angles and flips injected
into both, within 1e-5.  The classification chain's ops (the batch
RandomResizedCrop, MixupOrCutMix and RandomErasing) are held against JAX's
on JAX's own draws, replayed from its key and injected.  JAX draws with
threefry and torch with Philox, so each chain's own draws are checked for
reproducibility, shapes and the plain math on the draws it makes."""
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


# ---------------------------------------------------------------------------
# the classification pretraining chain
# ---------------------------------------------------------------------------

def _jax_uniforms(key, count, n):
    """The [0, 1) draws behind ``jax.random.uniform(k, (n,), lo, hi)``
    for each of *count* keys split from *key*, and the keys."""
    import jax
    keys = jax.random.split(key, count)
    return keys, [torch.from_numpy(np.asarray(jax.random.uniform(k, (n,))))
                  for k in keys]


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("scale, ratio, size", [
    ((0.08, 1.0), (3 / 4, 4 / 3), 12), ((0.8, 1.0), (0.2, 5.0), 20),
    ((1.0, 1.0), (1.0, 1.0), 16)])
def test_random_resized_crop_matches_jax_on_its_draws(dtype, scale, ratio,
                                                      size):
    import jax
    images = _images(dtype, n=5, h=21, w=27)
    key = jax.random.key(7)
    want = np.asarray(jax_augment.random_resized_crop_batch(
        key, jnp.asarray(images), size, scale=scale, ratio=ratio))
    _, (u_area, u_ratio, u_top, u_left) = _jax_uniforms(key, 4, 5)
    got = augment.random_resized_crop_batch(
        torch.from_numpy(images), size, u_area, u_ratio, u_top, u_left,
        scale=scale, ratio=ratio).numpy()
    assert got.shape == want.shape == (5, size, size, 3)
    assert got.dtype == want.dtype
    if dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_erase_matches_jax_on_its_draws(p):
    import jax
    images = _images(n=6, h=20, w=24)
    key = jax.random.key(11)
    want = np.asarray(jax_augment.erase_batch(key, jnp.asarray(images), p=p))
    keys, (u_gate, u_area, u_ratio, u_top, u_left) = _jax_uniforms(key, 5, 6)
    gate = torch.from_numpy(np.asarray(jax.random.bernoulli(keys[0], p,
                                                            (6,))))
    got = augment.erase_batch(torch.from_numpy(images), gate, u_area,
                              u_ratio, u_top, u_left).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("switch", [0.0, 0.5, 1.0])
def test_mixup_or_cutmix_matches_jax_on_its_draws(switch):
    import jax
    n, classes = 8, 5
    images = _images(n=n, h=16, w=12)
    labels = np.eye(classes, dtype=np.float32)[np.arange(n) % classes]
    key = jax.random.key(3)
    wx, wy = jax_augment.mixup_or_cutmix_batch(
        key, jnp.asarray(images), jnp.asarray(labels),
        switch_probability=switch, mixup_probability=0.8)
    (k_perm, k_switch, k_mgate, k_lam, k_cgate, k_beta, k_rx,
     k_ry) = jax.random.split(key, 8)

    def t(a):
        return torch.from_numpy(np.asarray(a))
    gx, gy = augment.mixup_or_cutmix_batch(
        torch.from_numpy(images), torch.from_numpy(labels),
        t(jax.random.permutation(k_perm, n)).long(),
        t(jax.random.bernoulli(k_switch, switch, (n,))),
        t(jax.random.uniform(k_lam, (n,))
          * jax.random.bernoulli(k_mgate, 0.8, (n,))),
        t(jax.random.bernoulli(k_cgate, 1.0, (n,))),
        t(jax.random.beta(k_beta, 1.0, 1.0, (n,))),
        t(jax.random.uniform(k_ry, (n,))), t(jax.random.uniform(k_rx, (n,))))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(gy.sum(-1).numpy(), 1.0, atol=1e-6)


def test_classification_chain_is_seeded_and_keeps_shapes():
    chain = augment.make_classification_device_augment(
        out_size=16, n_classes=7, crop_scale=(0.8, 1.0))
    batch = {"x": torch.from_numpy(_images(n=6, h=20, w=20)),
             "label": torch.tensor([0, 1, 2, 3, 4, 6], dtype=torch.int32),
             "other": torch.arange(6)}
    a = chain(torch.Generator().manual_seed(5), batch)
    b = chain(torch.Generator().manual_seed(5), batch)
    c = chain(torch.Generator().manual_seed(6), batch)
    assert a["x"].shape == (6, 16, 16, 3) and a["x"].dtype == torch.float32
    assert a["label"].shape == (6, 7) and a["label"].dtype == torch.float32
    torch.testing.assert_close(a["label"].sum(-1), torch.ones(6))
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["label"],
                                                       b["label"])
    assert not torch.equal(a["x"], c["x"])
    assert torch.equal(a["other"], batch["other"])
    # one-hot labels come through as they are
    onehot = dict(batch, label=torch.eye(7)[batch["label"].long()])
    torch.testing.assert_close(chain(torch.Generator().manual_seed(5),
                                     onehot)["label"], a["label"])


def test_classification_chain_computes_its_draws_plain_math():
    """The chain's output is the ops' plain math on the draws it makes, in
    its order: crop, flip, the mixing draws, erasing."""
    n, size = 4, 12
    x = torch.from_numpy(_images(n=n, h=18, w=18))
    label = torch.tensor([0, 1, 2, 1])
    chain = augment.make_classification_device_augment(
        out_size=size, n_classes=3, crop_scale=(0.5, 1.0),
        mixup_probability=0.8, erasing_probability=0.6)
    got = chain(torch.Generator().manual_seed(9), {"x": x, "label": label})

    g = torch.Generator().manual_seed(9)

    def u():
        return torch.rand((n,), generator=g)
    want = augment.random_resized_crop_batch(x, size, u(), u(), u(), u(),
                                             scale=(0.5, 1.0))
    flip = u() < 0.5
    want = torch.where(flip[:, None, None, None], want.flip(2), want)
    onehot = torch.eye(3)[label]
    perm = torch.randperm(n, generator=g)
    use_mixup = u() < 0.5
    lam = u() * (u() < 0.8)
    want, onehot = augment.mixup_or_cutmix_batch(
        want, onehot, perm, use_mixup, lam, u() < 1.0, u(), u(), u())
    gate = u() < 0.6
    want = augment.erase_batch(want, gate, u(), u(), u(), u())
    torch.testing.assert_close(got["x"], want, rtol=0, atol=0)
    torch.testing.assert_close(got["label"], onehot, rtol=0, atol=0)
