"""The port's CUDA kernel on the card: the flash-attention forward against
its plain version, its input checks and its launch count, and the
classifier on CUDA against the same weights on the CPU.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They
import neither JAX nor the JAX package, so they run on a machine without
JAX (the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from vit_torch_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# bf16 outputs of order 1 that differ by summation order and the final
# rounding (see chip_smoke.py)
ATOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _qkv(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 3, 1, 64), (2, 3, 65, 64),
                                   (1, 2, 130, 32), (3, 2, 257, 64)])
def test_kernel_matches_plain(cuda, shape):
    q, k, v = _qkv(shape, seed=shape[2], device=cuda)
    ref = fa.flash_attention_bhnd_reference(q, k, v).float()
    got = fa.flash_attention_bhnd(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == shape and got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max().item() <= ATOL
    # the (B, N, H, D) entry, reading strided views of one qkv tensor
    B, H, N, D = shape
    qkv = torch.stack([x.transpose(1, 2) for x in (q, k, v)], dim=2)
    out = fa.flash_attention(*qkv.unbind(2))
    assert out.is_contiguous() and out.shape == (B, N, H, D)
    assert (out.transpose(1, 2).float() - ref).abs().max().item() <= ATOL


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 16, 64), seed=0, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_bhnd(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bhnd(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bhnd(q[..., 1:33], k[..., 1:33], v[..., 1:33])
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention_bhnd(q.requires_grad_(), k, v)


def test_launch_count(cuda):
    q, k, v = _qkv((1, 1, 8, 32), seed=1, device=cuda)
    before = fa.flash_attention_bhnd.launches
    fa.flash_attention_bhnd(q, k, v)
    fa.flash_attention(q, k, v)
    assert fa.flash_attention_bhnd.launches == before + 2


def test_classifier_on_cuda_matches_cpu(cuda):
    """bf16 logits of one seeded model on the card (flash kernel) and on
    the CPU (plain attention)."""
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    models = [VisionModelZoo.get_model("vit_tiny_test", classifier=[10],
                                       image_size=32, device=dev)
              for dev in (cuda, "cpu")]
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    before = fa.flash_attention_bhnd.launches
    with torch.inference_mode():
        got, ref = (zm.model(torch.from_numpy(x).to(dev)).float().cpu()
                    for zm, dev in zip(models, (cuda, "cpu")))
    assert fa.flash_attention_bhnd.launches == before + 2   # depth 2
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-2, rtol=0)
