"""The zoo facade against the JAX package's, on the CPU: ``available_archs``,
every XCiT and ResNeXt/WRN arch built on the meta device,
``get_output_shape`` (one arch per family), ``remat`` (gradients and BN
statistics equal with and without it, with DropPath active), and
``state_dict_from_jax`` on conv kernels by value (every kernel of both
conv families is square, so a shape check cannot tell ``.T``'s kh/kw swap
from ``transpose(3, 2, 0, 1)``) and on the names of every family."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.models import resnet as jax_resnet
from vit_torch_tpu.models import xcit as jax_xcit
from vit_torch_tpu.models.zoo import VisionModelZoo as JaxZoo
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.models import layers, swin, vit, xcit
from vit_torch_tpu_torch.models.zoo import VisionModelZoo
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()


def test_available_archs_match_the_jax_facade():
    archs = VisionModelZoo.available_archs()
    assert archs == JaxZoo.available_archs()
    assert archs == sorted(set(archs))
    assert {"xcit_small_24_p16", "resnext50_32x4d", "wide_resnet101_2",
            "resnet_test", "xcit_test"} <= set(archs)


@pytest.mark.parametrize("arch", sorted(jax_xcit.XCIT_CONFIGS)
                         + sorted(jax_resnet.RESNET_CONFIGS))
def test_every_conv_family_arch_builds_on_meta(arch):
    """Each JAX XCiT and ResNet arch through ``get_model`` on the meta
    device (no weights drawn), with the JAX facade's metadata."""
    zm = VisionModelZoo.get_model(arch, classifier=[512, 10], device="meta")
    jzm = JaxZoo.get_model(arch, classifier=[512, 10])
    assert (zm.family, zm.feature_dim, zm.patch_size) == (
        jzm.family, jzm.feature_dim, jzm.patch_size)
    assert all(p.is_meta for p in zm.model.parameters())


# one arch per family, at a small image size; headless and with a head
SHAPE_CASES = [("vit_tiny_test", 32, None), ("swin_test", 32, [8, 3]),
               ("cait_test", 32, None), ("deit_test_distilled", 32, [5]),
               ("xcit_test", 32, [8, 3]), ("xcit_test", 48, None),
               ("resnet_test", 32, None), ("resnet_test", 64, [7])]


@pytest.mark.parametrize("arch,size,head", SHAPE_CASES, ids=str)
def test_get_output_shape_matches_jax(arch, size, head):
    """The port's shape probe (meta model, fake tensors) against the JAX
    facade's ``jax.eval_shape``, and against a real forward."""
    zm = VisionModelZoo.get_model(arch, classifier=head, image_size=size,
                                  device="cpu", dtype=torch.float32)
    want = JaxZoo.get_output_shape(
        JaxZoo.get_model(arch, classifier=head, image_size=size), size)
    got = VisionModelZoo.get_output_shape(zm, size)
    assert got == tuple(want)
    with torch.no_grad():
        assert tuple(zm.model(torch.zeros(1, size, size, 3)).shape) == got


# --------------------------------------------------------------------------
# remat

REMAT_CASES = {
    "vit": ("vit_dp_test", vit.VIT_CONFIGS,
            vit.ViTConfig(patch_size=8, embed_dim=64, depth=2, num_heads=2,
                          drop_path_rate=0.5)),
    "swin": ("swin_dp_test", swin.SWIN_CONFIGS,
             dataclasses.replace(swin.SWIN_CONFIGS["swin_test"],
                                 drop_path_rate=0.5)),
    "xcit": ("xcit_dp_test", xcit.XCIT_CONFIGS,
             dataclasses.replace(xcit.XCIT_CONFIGS["xcit_test"],
                                 drop_path_rate=0.5)),
    "resnet": ("resnet_test", None, None),
}


def _remat_run(arch, remat, seed):
    zm = VisionModelZoo.get_model(arch, classifier=[10], image_size=32,
                                  device="cpu", dtype=torch.float32,
                                  remat=remat)
    model = zm.model.train()
    layers.set_generator(model, torch.Generator().manual_seed(seed))
    blocks = [m for m in model.modules()
              if type(m).__name__ in ("Block", "SwinBlock", "XCABlock",
                                      "Bottleneck")]
    calls = []
    for blk in blocks:                 # counted in the recompute too
        blk.forward = (lambda f: lambda *a: calls.append(1) or f(*a))(
            blk.forward)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    out = model(x)
    out.square().sum().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return out.detach(), grads, state, len(calls), len(blocks)


@pytest.mark.parametrize("family", list(REMAT_CASES))
def test_remat_gives_the_gradients_without_remat(family, monkeypatch):
    """With ``remat`` every block runs twice (forward, and its recompute in
    the backward), and the gradients, the BN running statistics and the
    generator's next draw are those without remat: the recompute draws the
    forward's DropPath masks again from the trainer's generator and leaves
    the statistics as the forward left them.  DropPath is active (rate
    0.5: another seed gives other features)."""
    arch, configs, cfg = REMAT_CASES[family]
    if configs is not None:
        monkeypatch.setitem(configs, arch, cfg)
    out, grads, state, calls, n = _remat_run(arch, False, seed=5)
    r_out, r_grads, r_state, r_calls, _ = _remat_run(arch, True, seed=5)
    assert n and calls == n and r_calls == 2 * n
    torch.testing.assert_close(r_out, out, rtol=0, atol=0)
    assert set(r_grads) == set(grads)
    for name, g in grads.items():
        torch.testing.assert_close(r_grads[name], g, rtol=1e-6, atol=1e-7,
                                   msg=name)
    for key, v in state.items():
        assert torch.equal(r_state[key], v), key
    if family != "resnet":
        other, *_ = _remat_run(arch, False, seed=6)
        assert not torch.allclose(other, out)


def test_remat_is_off_without_a_recorded_gradient():
    zm = VisionModelZoo.get_model("xcit_test", image_size=32, device="cpu",
                                  remat=True)
    assert zm.model.backbone.remat
    calls = []
    blk = zm.model.backbone.blocks[0]
    blk.forward = (lambda f: lambda *a: calls.append(1) or f(*a))(
        blk.forward)
    with torch.no_grad():
        zm.model(torch.zeros(2, 32, 32, 3))
    assert calls == [1]


# --------------------------------------------------------------------------
# state_dict_from_jax on convs and names

@pytest.mark.parametrize("shape,groups", [((3, 3, 4, 6), 1),
                                          ((7, 7, 3, 8), 1),
                                          ((3, 3, 1, 5), 5),
                                          ((3, 3, 2, 8), 4),
                                          ((1, 1, 6, 4), 1)], ids=str)
def test_conv_kernels_carry_over_by_value(shape, groups):
    """A flax HWIO kernel becomes ``transpose(3, 2, 0, 1)`` of itself (not
    ``.T``, which swaps kh and kw), and the torch conv with it computes
    the XLA conv's output on a non-symmetric input."""
    rng = np.random.default_rng(sum(shape))
    kernel = rng.standard_normal(shape).astype(np.float32)
    sd = state_dict_from_jax({"conv": {"kernel": kernel}})
    w = sd["conv.weight"].numpy()
    np.testing.assert_array_equal(w, kernel.transpose(3, 2, 0, 1))
    if shape[0] > 1:
        assert not np.array_equal(w, kernel.T)
    cin = shape[2] * groups
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
    pad = shape[0] // 2
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kernel), (1, 1), ((pad, pad),) * 2,
        feature_group_count=groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
        padding=pad, groups=groups).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_names_of_every_family_carry_over():
    """The renames, and ResNet's ``layer1_0`` left alone by Swin's
    ``layers_(\\d+)_`` rule (and Swin's by ResNet's)."""
    k = np.zeros((3, 3, 2, 2), np.float32)
    v = np.zeros(2, np.float32)
    params = {"backbone": {
        "layer1_0": {"conv2": {"kernel": k}, "bn2": {"scale": v},
                     "downsample_conv": {"kernel": k},
                     "downsample_bn": {"bias": v}},
        "layers_1_blocks_0": {"norm1": {"scale": v}},
        "layers_0_downsample": {"norm": {"bias": v}},
        "patch_embed": {"conv3": {"kernel": k}, "bn3": {"scale": v}},
        "pos_proj_kernel": np.zeros((64, 2), np.float32),
        "pos_proj_bias": v,
        "blocks_1": {"local_mp": {"conv1": {"kernel": k}}},
        "cls_attn_blocks_0": {"gamma1": v},
        "blocks_token_only_1": {"attn": {"proj_l_kernel":
                                         np.zeros((2, 2), np.float32)}}}}
    stats = {"backbone": {"layer1_0": {"downsample_bn": {"mean": v}},
                          "patch_embed": {"bn3": {"var": v}}}}
    sd = state_dict_from_jax(params, batch_stats=stats)
    assert set(sd) == {
        "backbone.layer1.0.conv2.weight", "backbone.layer1.0.bn2.weight",
        "backbone.layer1.0.downsample.0.weight",
        "backbone.layer1.0.downsample.1.bias",
        "backbone.layers.1.blocks.0.norm1.weight",
        "backbone.layers.0.downsample.norm.bias",
        "backbone.patch_embed.proj.6.0.weight",
        "backbone.patch_embed.proj.6.1.weight",
        "backbone.pos_embeder.token_projection.weight",
        "backbone.pos_embeder.token_projection.bias",
        "backbone.blocks.1.local_mp.conv1.weight",
        "backbone.cls_attn_blocks.0.gamma1",
        "backbone.blocks_token_only.1.attn.proj_l.weight",
        "backbone.layer1.0.downsample.1.running_mean",
        "backbone.layer1.0.downsample.1.num_batches_tracked",
        "backbone.patch_embed.proj.6.1.running_var",
        "backbone.patch_embed.proj.6.1.num_batches_tracked"}
    assert sd["backbone.pos_embeder.token_projection.weight"].shape == (
        2, 64, 1, 1)
    assert sd["backbone.layer1.0.downsample.1.num_batches_tracked"].dtype \
        == torch.long
