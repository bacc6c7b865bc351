"""The port's Swin blocks (``medsegpretrainimagenet_tpu_torch.models.swin``)
against the JAX package's, module by module: the same numpy-seeded inputs
through both, weights transplanted with ``state_dict_from_jax``, float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.models import swin as jax_swin
from medsegpretrainimagenet_tpu_torch.models import swin

from torch_port_helpers import transplant


@pytest.mark.parametrize("ws", [(7, 7), (4, 4), (3, 5)])
def test_relative_position_index_equal(ws):
    np.testing.assert_array_equal(swin._relative_position_index(ws),
                                  jax_swin._relative_position_index(ws))


@pytest.mark.parametrize("res,window,shift", [(8, 4, 2), (56, 7, 3),
                                              (14, 7, 3)])
def test_shift_attn_mask_equal(res, window, shift):
    np.testing.assert_array_equal(
        swin._shift_attn_mask((res, res), window, shift),
        jax_swin._shift_attn_mask((res, res), window, shift))


def test_window_partition_and_reverse_equal():
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 3)) \
        .astype(np.float32)
    w = swin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jax_swin.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        swin.window_reverse(w, 4, 8, 8).numpy(), x)


def _block_kwargs(position):
    return dict(in_channels=16, img_size=64, patch_size=4, embed_dim=8,
                num_heads_layers=(1, 2, 4), window_size=4, position=position)


#: (id, JAX module, port module, input shape, extra call argument)
CASES = [
    ("patch_embed",
     lambda: jax_swin.PatchEmbed(in_channels=3, out_channels=8),
     lambda: swin.PatchEmbed(in_channels=3, out_channels=8), (2, 16, 16, 3)),
    ("patch_embed_dilation_2",
     lambda: jax_swin.PatchEmbed(in_channels=3, out_channels=96, dilation=2),
     lambda: swin.PatchEmbed(in_channels=3, out_channels=96, dilation=2),
     (2, 23, 23, 3)),
    ("patch_embed_groups_3",
     lambda: jax_swin.PatchEmbed(in_channels=3, out_channels=96, groups=3),
     lambda: swin.PatchEmbed(in_channels=3, out_channels=96, groups=3),
     (2, 16, 16, 3)),
    ("patch_merging",
     lambda: jax_swin.PatchMerging(in_channels=8, out_channels=16),
     lambda: swin.PatchMerging(in_channels=8, out_channels=16), (2, 64, 8)),
    ("patch_expand",
     lambda: jax_swin.PatchExpand(in_channels=16, out_channels=8),
     lambda: swin.PatchExpand(in_channels=16, out_channels=8), (2, 16, 16)),
    ("final_patch_expand_x4",
     lambda: jax_swin.FinalPatchExpand_X4(in_channels=8, out_channels=2),
     lambda: swin.FinalPatchExpand_X4(in_channels=8, out_channels=2),
     (2, 16, 8)),
    ("mlp",
     lambda: jax_swin.Mlp(in_features=8, hidden_features=32),
     lambda: swin.Mlp(in_features=8, hidden_features=32), (2, 10, 8)),
    ("window_attention",
     lambda: jax_swin.WindowAttention(dim=16, window_size=(4, 4),
                                      num_heads=2),
     lambda: swin.WindowAttention(dim=16, window_size=(4, 4), num_heads=2),
     (8, 16, 16)),
    ("swin_block_w_msa",
     lambda: jax_swin.SwinTransformerBlock(**_block_kwargs(0)),
     lambda: swin.SwinTransformerBlock(**_block_kwargs(0)), (2, 64, 16)),
    ("swin_block_sw_msa",
     lambda: jax_swin.SwinTransformerBlock(**_block_kwargs(1)),
     lambda: swin.SwinTransformerBlock(**_block_kwargs(1)), (2, 64, 16)),
    ("double_swin_block",
     lambda: jax_swin.DoubleSwinTransformerBlock(
         in_channels=32, img_size=64, embed_dim=8,
         num_heads_layers=(1, 2, 4), window_size=2),
     lambda: swin.DoubleSwinTransformerBlock(
         in_channels=32, img_size=64, embed_dim=8,
         num_heads_layers=(1, 2, 4), window_size=2), (2, 16, 32)),
]


@pytest.mark.parametrize("make_jax,make_port,shape",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_module_matches_jax(make_jax, make_port, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jax_module = make_jax()
    variables = jax_module.init(jax.random.key(0), jnp.asarray(x))
    ref = jax_module.apply(variables, jnp.asarray(x))
    port = transplant(variables, make_port())
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_window_attention_with_shift_mask_matches_jax():
    mask = swin._shift_attn_mask((8, 8), 4, 2)
    x = np.random.default_rng(2).standard_normal((8, 16, 16)) \
        .astype(np.float32)
    jax_module = jax_swin.WindowAttention(dim=16, window_size=(4, 4),
                                          num_heads=2)
    variables = jax_module.init(jax.random.key(0), jnp.asarray(x),
                                mask=jnp.asarray(mask))
    ref = jax_module.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask))
    port = transplant(variables, swin.WindowAttention(
        dim=16, window_size=(4, 4), num_heads=2))
    with torch.no_grad():
        out = port(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_block_geometry_matches_jax():
    for kwargs in (_block_kwargs(1), dict(_block_kwargs(1), in_channels=32,
                                          window_size=7)):
        _, res, window, shift = jax_swin.SwinTransformerBlock(
            **kwargs)._geometry()
        port = swin.SwinTransformerBlock(**kwargs)
        assert (port.resolution, port.window, port.shift) == \
            (res, window, shift)
