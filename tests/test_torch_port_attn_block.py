"""Port parity: the fused attention blocks (B3 and B4) against the JAX
package, on the CPU.

The plain versions against the Pallas ``_kernel`` and ``_kernel_packed``
in interpret mode (output, the packed qkv, and all five gradients through
the autograd Functions against ``jax.vjp`` of the custom VJPs); the
rounding points in bf16; a 2-block C = 128 ViT with ``VITX_FUSED_ATTN=1``
and ``VITX_PACKED_ATTN=1`` on both sides, forward and parameter
gradients; the dispatch under each flag and shape; ``cli.main`` under each
flag; and the port's importers against the published checkpoint layouts
(``fixtures/ckpt_manifests.json``).  Inputs come from numpy with a seed;
fp32 cases differ by summation order only, so their limits are a few
fp32 ulps of the values compared.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.models.vit import ViTConfig as JaxViTConfig
from vit_torch_tpu.models.vit import VisionTransformer as JaxViT
from vit_torch_tpu.ops import attn_block as jax_ab
from vit_torch_tpu_torch.checkpoint import torch_import
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.cli import main as cli_main
from vit_torch_tpu_torch.models import layers, vit
from vit_torch_tpu_torch.models.zoo import VisionModelZoo
from vit_torch_tpu_torch.ops import attn_block as ab
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

GRADS = ("x", "w_qkv", "b_qkv", "w_proj", "b_proj")


def _inputs(B, N, C, seed):
    """x of std 1, weights and biases of std 0.05 in the JAX layout (the
    kernel's (C, 3C) and (C, C), x @ W), as ``tests/test_attn_block.py``."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (B, N, C)).astype(np.float32),
            rng.normal(0, 0.05, (C, 3 * C)).astype(np.float32),
            rng.normal(0, 0.05, (3 * C,)).astype(np.float32),
            rng.normal(0, 0.05, (C, C)).astype(np.float32),
            rng.normal(0, 0.05, (C,)).astype(np.float32)]


def _port(args):
    """The same values for the port: weights in nn.Linear layout."""
    x, wq, bq, wp, bp = (None if a is None else torch.from_numpy(a)
                         for a in args)
    return [x, wq.t().contiguous(), bq, wp.t().contiguous(), bp]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


@pytest.mark.parametrize("N", [1, 40, 145])
@pytest.mark.parametrize("D", [64, 32])
def test_plain_attention_block_matches_pallas_kernel(N, D):
    """The port's B3 entry on the CPU (the plain version) against the
    Pallas ``_kernel`` in interpret mode (N padded to its 128-row chunk,
    padded keys masked), with biases and without; fp32."""
    C = 128
    args = _inputs(2, N, C, seed=N + D)
    for bias in (True, False):
        if not bias:
            args[2] = args[4] = None
        want = jax_ab.attention_block(*_jax(args), num_heads=C // D)
        calls = ab.attention_block_reference.calls
        got = ab.attention_block(*_port(args), num_heads=C // D)
        assert ab.attention_block_reference.calls == calls + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=3e-6, rtol=1e-5)


def test_bf16_rounds_where_the_pallas_kernel_does():
    """In bf16 the plain B3 rounds qkv, the unnormalised P, each head's
    output and the projection where ``_kernel`` does: its outputs equal
    the Pallas kernel's bit for bit but for a few elements one bf16 ulp
    apart (fp32 sums in another order), while the unfused path's
    rounding (products rounded before the bias, normalised P rounded)
    leaves many elements apart."""
    C, H = 128, 4
    args = _inputs(2, 40, C, seed=7)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in args]
    want = np.asarray(jax_ab.attention_block(*jb, num_heads=H), np.float32)
    tb = _port([np.asarray(a, np.float32) for a in jb])
    tb = [t.bfloat16() for t in tb]
    got = ab.attention_block(*tb, num_heads=H).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp
    assert (got != want).mean() <= 0.01
    attn = layers.Attention(C, H)
    attn.load_state_dict({"qkv.weight": tb[1].float(), "qkv.bias":
                          tb[2].float(), "proj.weight": tb[3].float(),
                          "proj.bias": tb[4].float()})
    with torch.no_grad():
        unfused = attn(tb[0]).float().numpy()
    assert (unfused != want).mean() >= 5 * (got != want).mean() + 0.01


@pytest.mark.parametrize("B,N", [(7, 17), (3, 5)])
def test_plain_packed_matches_pallas_packed_kernel(B, N):
    """The plain B4 against ``_kernel_packed`` in interpret mode (5 and 16
    images per 128-row pack, a ragged last pack): the output and the qkv
    projection it saves for the backward."""
    C, H = 128, 4
    args = _inputs(B, N, C, seed=B)
    x, wq, bq, wp, bp = _jax(args)
    want_out, want_qkv = jax_ab._fwd_impl_packed(
        x, wq, bq.reshape(1, -1), wp, bp.reshape(1, -1), H, (C // H) ** -0.5)
    calls = ab.attention_block_packed_reference.calls
    out, qkv = ab.attention_block_packed_fwd(*_port(args), num_heads=H)
    assert ab.attention_block_packed_reference.calls == calls + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=3e-6, rtol=1e-5)
    np.testing.assert_allclose(qkv.numpy(), np.asarray(want_qkv),
                               atol=3e-6, rtol=1e-5)


@pytest.mark.parametrize("packed", [False, True], ids=["b3", "b4"])
def test_attention_block_grads_match_jax_vjp(packed):
    """All five gradients of the port's Functions (B3: the recompute
    through the flash attention's plain forward and backward; B4: the
    analytic backward over the saved qkv) against ``jax.vjp`` through the
    JAX custom VJPs (``_ab_bwd`` through the Pallas flash kernels in
    interpret mode, ``_abp_bwd``); fp32, max |port - JAX| within 1e-5 of
    max |JAX| of each gradient."""
    B, N, C, H = (6, 17, 128, 4) if packed else (2, 40, 128, 4)
    args = _inputs(B, N, C, seed=3)
    r = np.random.default_rng(9).standard_normal((B, N, C)).astype(
        np.float32)
    jfn = jax_ab.attention_block_packed if packed else jax_ab.attention_block
    fn = ab.attention_block_packed if packed else ab.attention_block
    want, vjp = jax.vjp(lambda *a: jfn(*a, num_heads=H), *_jax(args))
    wgrads = vjp(jnp.asarray(r))
    leaves = [t.requires_grad_(True) for t in _port(args)]
    got = fn(*leaves, num_heads=H)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=3e-6, rtol=1e-5)
    for name, leaf, w in zip(GRADS, leaves, wgrads):
        w = np.asarray(w)
        if name.startswith("w_"):
            w = w.T                              # nn.Linear layout
        err = np.abs(leaf.grad.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, (name, err)


# the model-level parity config: C = 128 fits both packages' kernels
# (the JAX fits() needs C % 128 = 0; vit_tiny_test has C = 64)
CFG = dict(patch_size=8, embed_dim=128, depth=2, num_heads=4)


@pytest.mark.parametrize("flag,size", [("VITX_FUSED_ATTN", 64),
                                       ("VITX_PACKED_ATTN", 32)])
def test_vit_backbone_and_grads_match_jax_under_flag(flag, size,
                                                     monkeypatch):
    """The 2-block C = 128 ViT with the flag set on both sides (the JAX
    model through the Pallas kernel in interpret mode, the port through
    its Function on the plain version): features and the gradient of every
    backbone parameter of ``sum(features * r)``, max |port - JAX| within
    1e-4 of max |JAX| of each gradient; one kernel call per block."""
    monkeypatch.setenv(flag, "1")
    jmodel = JaxViT(JaxViTConfig(**CFG), dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]
    r = np.random.default_rng(4).standard_normal((2, 128)).astype(np.float32)

    def loss(p):
        feats = jmodel.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(feats * r), feats

    (_, want), wgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    wgrads = state_dict_from_jax(jax.tree.map(np.asarray, wgrads))
    model = vit.VisionTransformer(vit.ViTConfig(**CFG), image_size=size,
                                  dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params))
    counter = (ab.attention_block_packed_reference if "PACKED" in flag
               else ab.attention_block_reference)
    calls = counter.calls
    got = model(torch.from_numpy(x))
    (got * torch.from_numpy(r)).sum().backward()
    assert counter.calls == calls + CFG["depth"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(wgrads)
    for n, w in wgrads.items():
        err = (grads[n] - w).abs().max().item() / w.abs().max().item()
        assert err <= 1e-4, (n, err)


def _route(env, monkeypatch, N, C=128, H=4):
    """The route one Attention call takes under ``env``, read from the
    plain versions' counters (the CPU runs them)."""
    for name in ("VITX_FUSED_ATTN", "VITX_PACKED_ATTN"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    before = (ab.attention_block_reference.calls,
              ab.attention_block_packed_reference.calls)
    with torch.no_grad():
        layers.Attention(C, H)(torch.zeros((2, N, C)))
    after = (ab.attention_block_reference.calls,
             ab.attention_block_packed_reference.calls)
    return {(1, 0): "fused", (0, 1): "packed", (0, 0): "unfused"}[
        (after[0] - before[0], after[1] - before[1])]


@pytest.mark.parametrize("env,N,C,H,route", [
    ({}, 17, 128, 4, "unfused"),
    ({"VITX_FUSED_ATTN": "1"}, 197, 128, 4, "fused"),
    ({"VITX_FUSED_ATTN": "1"}, 17, 96, 3, "unfused"),      # C % 64 != 0
    ({"VITX_FUSED_ATTN": "1"}, 17, 384, 8, "unfused"),     # head dim 48
    ({"VITX_FUSED_ATTN": "0"}, 197, 128, 4, "unfused"),
    ({"VITX_PACKED_ATTN": "1"}, 17, 128, 4, "packed"),
    ({"VITX_PACKED_ATTN": "1"}, 33, 128, 4, "unfused"),    # N > 32
    ({"VITX_PACKED_ATTN": "1", "VITX_FUSED_ATTN": "1"}, 17, 128, 4,
     "packed"),
    ({"VITX_PACKED_ATTN": "1", "VITX_FUSED_ATTN": "1"}, 33, 128, 4,
     "fused"),
], ids=str)
def test_dispatch_follows_the_jax_flags(env, N, C, H, route, monkeypatch):
    assert _route(env, monkeypatch, N, C, H) == route


@pytest.mark.parametrize("env,B,N,fused", [
    ({}, 64, 197, False),                    # dino_vits16 @224 bs64
    ({}, 128, 197, False),                   # bs128
    ({}, 8, 785, False),                     # dino_vitb8 @224
    ({}, 128, 17, False),                    # dino_vitb8 @32
    ({"VITX_FUSED_ATTN": "0"}, 64, 197, False),
    ({"VITX_FUSED_ATTN": "1"}, 64, 197, True),
], ids=str)
def test_fused_default(env, B, N, fused, monkeypatch):
    """B3 is opt-in: without ``VITX_FUSED_ATTN=1`` no shape takes it, on a
    tensor off the CPU too (``models/layers.py`` cites the H100 step
    times behind that)."""
    monkeypatch.delenv("VITX_FUSED_ATTN", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    x = torch.empty((B, N, 384), device="meta")
    assert layers._fused_attention(x, 6) == fused


@pytest.mark.parametrize("flag", ["VITX_FUSED_ATTN", "VITX_PACKED_ATTN"])
def test_cli_main_under_each_flag(flag, tmp_path, monkeypatch):
    """``cli.main --device cpu`` fine-tunes the C = 128 ViT at 32 px
    (N = 17) with the flag set: every block through the flag's plain
    version, finite losses."""
    monkeypatch.setitem(vit.VIT_CONFIGS, "vit_c128_test",
                        vit.ViTConfig(**CFG))
    monkeypatch.setenv(flag, "1")
    counter = (ab.attention_block_packed_reference if "PACKED" in flag
               else ab.attention_block_reference)
    calls = counter.calls
    fp = str(tmp_path / "stats.json")
    cli_main.main(["--dataset", "synthetic", "--arch", "vit_c128_test",
                   "--image_size", "32", "--epoch", "1", "--bs", "16",
                   "--limit_train", "32", "--limit_test", "16", "--scan",
                   "0", "--device", "cpu", "--stats_fp", fp])
    stats = json.load(open(fp))
    # 2 train steps and 1 eval step, 2 blocks each
    assert counter.calls == calls + 2 * (2 + 1)
    assert all(np.isfinite(r["loss"]) for r in stats["train"] + stats["val"])


# --------------------------------------------------------------------------
# the importers against the published checkpoint layouts

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "ckpt_manifests.json")) as f:
    MANIFESTS = json.load(f)


# published checkpoint -> (keys the backbone takes, keys in the file)
PUBLISHED_KEYS = {"dino_vitb8": (150, 150), "dino_vits16": (150, 150),
                  "cait_s24_224": (474, 476),
                  "swin_base_patch4_window12_384_22k": (327, 364),
                  "deit_base_distilled_patch16_224": (151, 155),
                  "xcit_small_24_p16": (705, 707),
                  "resnext50_32x4d": (318, 320)}
# a full-size detector -> the published backbone it loads
DETECTORS = {"faster_rcnn_resnext50_32x4d": "resnext50_32x4d"}


def _meta_model(name, image_size):
    """The zoo backbone, or the full-size detector, on the meta device."""
    if name in DETECTORS:
        from vit_torch_tpu_torch.detection.faster_rcnn import (
            FasterRCNNConfig, build_faster_rcnn)
        return build_faster_rcnn(FasterRCNNConfig(), DETECTORS[name],
                                 device="meta")
    return VisionModelZoo.get_model(name, image_size=image_size,
                                    device="meta").model


@pytest.mark.parametrize("name", list(PUBLISHED_KEYS) + list(DETECTORS))
def test_importer_loads_the_published_layout(name, tmp_path, monkeypatch):
    """A full-size backbone on the meta device takes a state dict of the
    published checkpoint's keys and shapes (zeros backed by calloc, in
    the file's own wrapping and prefix) through the port's loader: every
    key the backbone needs is there with its shape (XCiT's and ResNeXt's
    BatchNorm running statistics and batch counts too), and the keys it
    leaves are the classifier heads (DeiT's two, torchvision's ``fc``)
    and Swin's computed buffers only.  The full-size Faster R-CNN over
    resnext50_32x4d (FPN 256, 91 classes, 512 px) takes the same
    checkpoint into its trunk."""
    published = DETECTORS.get(name, name)
    man = MANIFESTS[published]
    model = _meta_model(name, man["image_size"])
    prefix = "module." if man["module_prefix"] else ""
    sd = {prefix + k: torch.from_numpy(np.zeros(shape, dtype))
          for k, (shape, dtype) in man["keys"].items()}
    monkeypatch.setattr(torch_import.torch, "load",
                        lambda *a, **k: {man["wrapper"]: sd}
                        if man["wrapper"] else sd)
    path = tmp_path / "checkpoint.pth"
    path.touch()
    with pytest.warns(UserWarning, match="meta"):
        torch_import.load_backbone_state_dict(str(path), model,
                                              man["image_size"])
    needed = model.backbone.state_dict()
    for k, v in needed.items():
        assert tuple(man["keys"][k][0]) == tuple(v.shape), k
    left = set(man["keys"]) - set(needed)
    assert all(k.startswith(("head.", "head_dist.", "fc.")) or k.endswith(
        ("relative_position_index", "attn_mask")) for k in left), left
    assert (len(needed), len(man["keys"])) == PUBLISHED_KEYS[published]


# (B, N, C, heads, packed) -> (columns a warpgroup projects in one pass,
# passes, blocks): csrc/attn_block.cu's blocks take 64 query rows (B3) or
# a pack of 64 // N images (B4); the two warpgroups take half the columns
# each, in passes of at most 384
@pytest.mark.parametrize("shape,plan", [
    ((64, 197, 384, 6, False), (192, 1, 256)),    # dino_vits16 bs64
    ((128, 197, 384, 6, False), (192, 1, 512)),   # bs128
    ((32, 785, 768, 12, False), (384, 1, 416)),   # dino_vitb8 @224
    ((3, 37, 128, 2, False), (128, 1, 3)),        # ragged
    ((128, 17, 768, 12, True), (384, 1, 43)),     # B4: dino_vitb8 @32
    ((7, 5, 128, 4, True), (128, 1, 1)),          # B4: ragged pack
    ((2, 130, 256, 8, False), (128, 1, 6)),       # head dim 32
    ((13, 9, 256, 8, True), (128, 1, 2)),         # B4, head dim 32
    ((2, 197, 1024, 16, False), (256, 2, 8)),     # ViT-L: two passes
    ((2, 65, 64, 1, False), (128, 1, 4)),         # one head: WG 1 idles
    ((2, 70, 448, 7, False), (256, 1, 4)),        # odd head count
    ((5, 48, 128, 2, True), (128, 1, 5)),         # B4: one image a pack
], ids=str)
def test_launch_plan_covers_the_columns(shape, plan):
    """The passes of the two warpgroups cover the columns, a pass at most
    384 of them; one block per 64-row tile (B3) or pack (B4)."""
    B, N, C, H, packed = shape
    got = ab.launch_plan(B, N, C, H, packed=packed)
    assert tuple(got) == plan
    assert 2 * got.passes * got.pass_cols >= C
    assert got.pass_cols <= 384


@pytest.mark.parametrize("shape,packed", [
    ((2, 17, 384, 8), False),      # head dim 48
    ((2, 17, 96, 3), False),       # C not a multiple of 64
    ((2, 17, 1280, 20), False),    # C over MAX_CHANNELS
    ((2, 49, 128, 2), True),       # a pack takes N <= 48
], ids=str)
def test_launch_plan_refuses_shapes_the_kernel_does_not_take(shape, packed):
    with pytest.raises(ValueError):
        ab.launch_plan(*shape, packed=packed)


class _OnCard:
    """Stands in for a CUDA token block where there is no card: the entry
    points read only its shape and device before they launch."""
    shape = (2, 17, 128)
    device = torch.device("cuda")


@pytest.mark.parametrize("packed", [False, True], ids=["b3", "b4"])
def test_cuda_tensor_never_takes_the_plain_version(packed, monkeypatch):
    """A CUDA block goes to the kernel chain (``_launch``), never to the
    plain version."""
    launched = []

    def launch(x, *args, packed):
        launched.append(packed)
        return "out", "qkv"

    def plain(*args):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ab, "_launch", launch)
    monkeypatch.setattr(ab, "_reference_parts", plain)
    fn = ab.attention_block_packed if packed else ab.attention_block
    wq, wp = torch.empty((384, 128)), torch.empty((128, 128))
    with torch.no_grad():
        assert fn(_OnCard(), wq, None, wp, None, num_heads=2) == "out"
    assert launched == [packed]


@pytest.mark.parametrize("packed", [False, True], ids=["b3", "b4"])
def test_other_devices_raise_without_the_plain_version(packed):
    """A tensor neither on the CPU nor on CUDA raises, and the plain
    version does not run."""
    x = torch.empty((2, 17, 128), device="meta")
    wq, bq = torch.empty((384, 128), device="meta"), None
    wp = torch.empty((128, 128), device="meta")
    ref = (ab.attention_block_packed_reference if packed
           else ab.attention_block_reference)
    calls = ref.calls
    fn = ab.attention_block_packed if packed else ab.attention_block
    with pytest.raises(ValueError, match="no attention block"):
        fn(x, wq, bq, wp, None, num_heads=2)
    assert ref.calls == calls
