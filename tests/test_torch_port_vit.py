"""Port parity: the port's ViT classifier against the JAX package's, on the
same weights (JAX init → ``state_dict_from_jax``) and the same numpy
images, and the port's parameter names against the JAX package's DINO
importer."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.checkpoint.torch_import import (
    import_backbone, interpolate_pos_embed as jax_interpolate_pos_embed)
from vit_torch_tpu.models.layers import ClassifierHead as JaxHead
from vit_torch_tpu.models.vit import VIT_CONFIGS as JAX_CONFIGS
from vit_torch_tpu.models.vit import ViTConfig as JaxViTConfig
from vit_torch_tpu.models.vit import VisionTransformer as JaxViT
from vit_torch_tpu.models.zoo import Classifier as JaxClassifier
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.checkpoint.torch_import import interpolate_pos_embed
from vit_torch_tpu_torch.models.layers import ClassifierHead
from vit_torch_tpu_torch.models.vit import ViTConfig, VisionTransformer
from vit_torch_tpu_torch.models.zoo import Classifier
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

# (name, config, image size): the repo's tiny test arch (head dim 32) and a
# head-dim-64 model as dino_vitb8 has
CASES = [
    ("vit_tiny_test", (("patch_size", 8), ("embed_dim", 64), ("depth", 2),
                       ("num_heads", 2)), 32),
    ("d64", (("patch_size", 16), ("embed_dim", 128), ("depth", 2),
             ("num_heads", 2)), 64),
]
HEAD = (16, 10)
FP32_ATOL = 1e-4
# bf16 activations: both sides round after every matmul, LayerNorm and
# GELU, but at different points (fused bias epilogues, PV before or after
# normalisation), so logits agree to a few bf16 ulps of their size
BF16_ATOL = 3e-2


@functools.lru_cache(maxsize=None)
def _models(case, dtype):
    name, cfg, size = case
    cfg = dict(cfg)
    jax_dt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = JAX_CONFIGS[name] if name in JAX_CONFIGS else JaxViTConfig(**cfg)
    jm = JaxClassifier(JaxViT(jcfg, dtype=jax_dt, name="backbone"),
                       JaxHead(HEAD, dtype=jax_dt, name="head"))
    variables = jax.jit(jm.init, static_argnums=2)(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, size, size, 3), jnp.float32), True)
    params = jax.tree.map(np.asarray, variables["params"])
    tm = Classifier(VisionTransformer(ViTConfig(**cfg), image_size=size,
                                      dtype=dtype),
                    ClassifierHead(cfg["embed_dim"], HEAD))
    tm.load_state_dict(state_dict_from_jax(params))
    return jm, variables, tm.eval()    # shared by tests: read only


def _images(size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, size, size, 3)).astype(np.float32)


def _logits(jm, variables, tm, x):
    # a fresh jit per call: the JAX attention dispatch reads VITX_ATTN_BHND
    # while tracing
    apply = jax.jit(lambda v, x: jm.apply(v, x, True))
    ref = np.asarray(apply(variables, jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).float().numpy()
    return got, ref


@pytest.mark.parametrize("bhnd", ["0", "1"], ids=["xla_path", "flash_path"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_vit_logits_match_jax_fp32(case, bhnd, monkeypatch):
    """fp32 logits on the JAX CPU path, and with VITX_ATTN_BHND=1 through
    the JAX flash kernel (interpret mode)."""
    monkeypatch.setenv("VITX_ATTN_BHND", bhnd)
    jm, variables, tm = _models(case, torch.float32)
    got, ref = _logits(jm, variables, tm, _images(case[2]))
    assert got.shape == ref.shape == (3, HEAD[-1])
    np.testing.assert_allclose(got, ref, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_vit_logits_match_jax_bf16(case):
    jm, variables, tm = _models(case, torch.bfloat16)
    got, ref = _logits(jm, variables, tm, _images(case[2], seed=1))
    np.testing.assert_allclose(got, ref, atol=BF16_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_state_dict_names_are_dino(case):
    """port state_dict → the JAX package's DINO importer → the JAX params
    back, leaf for leaf."""
    jm, variables, tm = _models(case, torch.float32)
    sd = {k[len("backbone."):]: v.numpy()
          for k, v in tm.state_dict().items() if k.startswith("backbone.")}
    target = variables["params"]["backbone"]
    imported = import_backbone("dino", sd, target)["params"]
    flat_t = jax.tree_util.tree_flatten_with_path(target)[0]
    flat_i = dict(jax.tree_util.tree_flatten_with_path(imported)[0])
    assert len(flat_t) == len(flat_i)
    for path, leaf in flat_t:
        np.testing.assert_array_equal(np.asarray(flat_i[path]),
                                      np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_interpolate_pos_embed_matches_jax():
    rng = np.random.default_rng(5)
    pos = rng.standard_normal((1, 1 + 16, 8)).astype(np.float32)
    for target in (36, 9, 16):                # grow, shrink, keep
        np.testing.assert_allclose(
            interpolate_pos_embed(pos, target),
            jax_interpolate_pos_embed(pos, target), atol=1e-5, rtol=0)
