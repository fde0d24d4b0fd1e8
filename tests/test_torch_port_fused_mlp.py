"""Port parity: the fused MLP (B12) against the JAX package, on the CPU.

The plain version against the Pallas ``_kernel`` in interpret mode: fp32
(with leading dims, ``out_dim != C`` and without biases) and bf16 for the
rounding points; all five gradients of the autograd Function against
``jax.vjp`` of the custom VJP; the ``Mlp`` module under
``VITX_FUSED_MLP=1`` and ``=0`` on both sides; the dispatch and the
kernel's shape rule.  Inputs come from numpy with a seed.  In fp32 the
two sides differ by summation order and by the TPU kernel's
Abramowitz-Stegun erf (|err| <= 1.5e-7) against ``torch.erf``: a few fp32
ulps of the values compared.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.models import layers as jax_layers
from vit_torch_tpu_torch.models import layers
from vit_torch_tpu_torch.ops import fused_mlp as fm

# the module (the JAX package's ops/__init__ exports the function of the
# same name)
jax_fm = importlib.import_module("vit_torch_tpu.ops.fused_mlp")
GRADS = ("x", "w1", "b1", "w2", "b2")


def _inputs(lead, C, Hd, Co, seed, bias=True):
    """x of std 1, weights of std 1/sqrt(fan in) and biases of std 0.1 in
    the JAX layout (w1 (C, Hd), w2 (Hd, Co), x @ W)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (*lead, C)).astype(np.float32),
            rng.normal(0, C ** -0.5, (C, Hd)).astype(np.float32),
            rng.normal(0, 0.1, (Hd,)).astype(np.float32) if bias else None,
            rng.normal(0, Hd ** -0.5, (Hd, Co)).astype(np.float32),
            rng.normal(0, 0.1, (Co,)).astype(np.float32) if bias else None]


def _port(args, dtype=torch.float32):
    """The same values for the port: weights in nn.Linear layout."""
    x, w1, b1, w2, b2 = (None if a is None else torch.from_numpy(a)
                         for a in args)
    return [None if t is None else t.to(dtype)
            for t in (x, w1.t().contiguous(), b1, w2.t().contiguous(), b2)]


def _jax(args, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


@pytest.mark.parametrize("lead,Co,bias", [((2, 40), 128, True),
                                          ((96,), 256, False),
                                          ((3, 4, 8), 128, True)], ids=str)
def test_plain_fused_mlp_matches_pallas_kernel(lead, Co, bias):
    """The port's entry on the CPU (the plain version) against the Pallas
    ``_kernel`` in interpret mode, fp32: max |port - JAX| within 1e-5 of
    max |JAX|."""
    C, Hd = 128, 512
    args = _inputs(lead, C, Hd, Co, seed=len(lead) + Co, bias=bias)
    T = int(np.prod(lead))
    assert jax_fm.fits(T, C, Hd, Co) and fm.fits(T, C, Hd, Co)
    want = np.asarray(jax_fm.fused_mlp(*_jax(args)))
    calls = fm.fused_mlp_reference.calls
    got = fm.fused_mlp(*_port(args)).numpy()
    assert fm.fused_mlp_reference.calls == calls + 1
    assert got.shape == (*lead, Co)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_bf16_rounds_where_the_pallas_kernel_does():
    """In bf16 the plain version rounds the hidden activation and the
    output where ``_kernel`` does: within 2e-2 of max |JAX| (one bf16 ulp
    of a hidden value carried through fc2), and closer to the kernel than
    the XLA path's rounding (each product rounded before its bias)."""
    C, Hd, Co = 128, 512, 128
    args = _inputs((2, 40), C, Hd, Co, seed=7)
    want = np.asarray(jax_fm.fused_mlp(*_jax(args, jnp.bfloat16)),
                      np.float32)
    tb = _port([np.asarray(a, np.float32) for a in _jax(args, jnp.bfloat16)],
               torch.bfloat16)
    got = fm.fused_mlp(*tb).float().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale
    xla = fm._recompute(*tb).float().numpy()
    assert (got != want).mean() < (xla != want).mean()


def test_fused_mlp_grads_match_jax_vjp():
    """All five gradients of the port's Function (the recompute of
    ``_ref_forward``) against ``jax.vjp`` through the custom VJP
    (``_mlp_bwd``), fp32: max |port - JAX| within 1e-5 of max |JAX| of
    each gradient."""
    C, Hd, Co = 128, 512, 256
    args = _inputs((2, 40), C, Hd, Co, seed=3)
    r = np.random.default_rng(9).standard_normal((2, 40, Co)).astype(
        np.float32)
    want, vjp = jax.vjp(jax_fm.fused_mlp, *_jax(args))
    wgrads = vjp(jnp.asarray(r))
    leaves = [t.requires_grad_(True) for t in _port(args)]
    got = fm.fused_mlp(*leaves)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for name, leaf, w in zip(GRADS, leaves, wgrads):
        w = np.asarray(w)
        if name.startswith("w"):
            w = w.T                              # nn.Linear layout
        err = np.abs(leaf.grad.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, (name, err)


def _mlp_pair(C=128, hidden=512, seed=0):
    """The JAX ``Mlp`` (fp32) with its init params and the port's ``Mlp``
    with the same weights."""
    jmlp = jax_layers.Mlp(hidden, dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, 24, C)).astype(
        np.float32)
    params = jmlp.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    mlp = layers.Mlp(C, hidden)
    mlp.load_state_dict({
        f"{fc}.{name}": torch.tensor(np.asarray(
            params[fc]["kernel"]).T if name == "weight" else np.asarray(
            params[fc]["bias"]))
        for fc in ("fc1", "fc2") for name in ("weight", "bias")})
    return jmlp, params, mlp, x


@pytest.mark.parametrize("flag", ["1", "0"])
def test_mlp_module_matches_jax_under_the_flag(flag, monkeypatch):
    """The ``Mlp`` module with ``VITX_FUSED_MLP`` set on both sides: under
    ``=1`` both take their kernel's route (the JAX ``fits`` holds at C =
    128, hidden 512, so the Pallas kernel runs in interpret mode; the port
    runs the plain version once), under ``=0`` neither does; output and
    the gradients of every parameter and of x agree."""
    monkeypatch.setenv("VITX_FUSED_MLP", flag)
    jmlp, params, mlp, x = _mlp_pair()
    assert jax_fm.fits(2 * 24, 128, 512, 128)
    r = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def loss(p, x):
        y = jmlp.apply({"params": p}, x)
        return jnp.sum(y * r), y

    (_, want), (wp, wx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    calls = fm.fused_mlp_reference.calls
    xt = torch.from_numpy(x).requires_grad_(True)
    got = mlp(xt)
    (got * torch.from_numpy(r)).sum().backward()
    assert fm.fused_mlp_reference.calls == calls + (flag == "1")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    pairs = [(xt.grad, wx), (mlp.fc1.weight.grad, wp["fc1"]["kernel"].T),
             (mlp.fc1.bias.grad, wp["fc1"]["bias"]),
             (mlp.fc2.weight.grad, wp["fc2"]["kernel"].T),
             (mlp.fc2.bias.grad, wp["fc2"]["bias"])]
    for g, w in pairs:
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("env,shape,hidden,train_drop,fused", [
    ({}, (2, 24, 128), 512, False, False),
    ({"VITX_FUSED_MLP": "0"}, (2, 24, 128), 512, False, False),
    ({"VITX_FUSED_MLP": "1"}, (2, 24, 128), 512, False, True),
    ({"VITX_FUSED_MLP": "1"}, (32, 198, 768), 3072, False, True),
    ({"VITX_FUSED_MLP": "1"}, (2, 24, 128), 512, True, False),   # dropout
    ({"VITX_FUSED_MLP": "1"}, (2, 24, 64), 256, False, False),   # C < 128
    ({"VITX_FUSED_MLP": "1"}, (2, 24, 128), 480, False, False),  # Hd % 64
], ids=str)
def test_dispatch_follows_the_jax_flag(env, shape, hidden, train_drop,
                                       fused, monkeypatch):
    """B12 is opt-in, off without the flag on every device, off while
    dropout is active, and only at the shapes the CUDA kernel takes."""
    monkeypatch.delenv("VITX_FUSED_MLP", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    mlp = layers.Mlp(shape[-1], hidden, dropout=0.1 if train_drop else 0.0)
    mlp.train(train_drop)
    assert layers._fused_mlp(torch.empty(shape, device="meta"), mlp) == fused


@pytest.mark.parametrize("T,C,Hd,Co,ok", [
    (6336, 768, 3072, 768, True),        # DeiT-base bs32
    (294912, 128, 512, 128, True),       # swin_base_384 stage 1 bs32
    (5, 192, 768, 192, True),            # swin_tiny stage 2, ragged T
    (7, 128, 512, 200, True),            # out_dim != C
    (7, 64, 256, 64, False),             # C below two k-steps
    (7, 96, 384, 96, False),             # C % 64 (swin_tiny stage 1)
    (7, 128, 96, 128, False),            # hidden % 64
    (7, 128, 512, 12, False),            # out % 8
    (0, 128, 512, 128, False),
], ids=str)
def test_fits_states_the_kernels_shapes(T, C, Hd, Co, ok):
    assert fm.fits(T, C, Hd, Co) == ok


def test_cuda_tensor_never_takes_the_plain_version():
    """A tensor off the CPU reaches the kernel's checks, never the plain
    version: on the meta device the wrapper raises."""
    x = torch.empty((4, 128), device="meta")
    w1, w2 = torch.empty((512, 128), device="meta"), torch.empty(
        (128, 512), device="meta")
    calls = fm.fused_mlp_reference.calls
    with pytest.raises(ValueError, match="no fused MLP"):
        fm.fused_mlp(x, w1, None, w2, None)
    assert fm.fused_mlp_reference.calls == calls
