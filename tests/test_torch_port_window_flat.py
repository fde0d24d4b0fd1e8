"""Port parity: the flat window block (B7) against the JAX package, on the
CPU.

The plain version against the Pallas ``_fwd_kernel`` in interpret mode
(masked and unmasked, at N = 16 and at N = 49, which the JAX wrapper pads
to 64 with the padded keys masked), and the gradients of the autograd
Function (the plain B6 backward here) against ``jax.vjp`` of the custom
VJP; then a small Swin with ``VITX_FUSED_SPATIAL=0`` on both sides (the
JAX model with ``VITX_FUSED_BLOCK=1``) on maps that need padding, so that
no block takes the whole-block kernel on either side: features and the
gradient of every parameter.  Inputs come from numpy with a seed; fp32,
with the JAX package's own tolerances (``tests/test_fused_block.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.models import swin as jax_swin
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.models import swin
from vit_torch_tpu_torch.ops import window_block as wb

# the module (the JAX package's ops/__init__ may export a function of the
# same name)
jax_wb = importlib.import_module("vit_torch_tpu.ops.window_block")
GRADS = ("x", "w_qkv", "b_qkv", "bias", "w_proj", "b_proj")


def _inputs(Bn, N, C, H, nW, seed):
    """As ``tests/test_fused_block.py:_wb_inputs``: x of std 1, weights
    and biases of std 0.05 (JAX layout), a bias table of std 0.5, a mask
    of 0 and -100."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (Bn, N, C)).astype(np.float32),
            rng.normal(0, 0.05, (C, 3 * C)).astype(np.float32),
            rng.normal(0, 0.05, (3 * C,)).astype(np.float32),
            rng.normal(0, 0.5, (H, N, N)).astype(np.float32),
            np.where(rng.random((nW, N, N)) > 0.7, -100.0,
                     0.0).astype(np.float32),
            rng.normal(0, 0.05, (C, C)).astype(np.float32),
            rng.normal(0, 0.05, (C,)).astype(np.float32)]


def _port(args):
    """The same values for the port: weights in nn.Linear layout."""
    x, wq, bq, bias, mask, wp, bp = (None if a is None else
                                     torch.from_numpy(a) for a in args)
    return [x, wq.t().contiguous(), bq, bias, mask, wp.t().contiguous(), bp]


@pytest.mark.parametrize("N", [16, 49])
@pytest.mark.parametrize("masked", [True, False])
def test_plain_window_block_matches_pallas_kernel(N, masked):
    """The port's B7 on the CPU (the plain version) against the Pallas
    ``_fwd_kernel`` in interpret mode, fp32: atol 3e-5, rtol 1e-4 (the
    JAX package's limits for the op)."""
    Bn, C, H, nW = 8, 128, 4, 4
    args = _inputs(Bn, N, C, H, nW, seed=N)
    if not masked:
        args[4] = None
    assert jax_wb.fits(Bn, N, C, H, nW if masked else None)
    want = jax_wb.window_block(*[None if a is None else jnp.asarray(a)
                                 for a in args], num_heads=H)
    got = wb.window_block(*_port(args), num_heads=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("N", [16, 49])
def test_window_block_grads_match_jax_vjp(N):
    """All six gradients of the port's Function (the saved qkv and
    attention output, the plain B6 backward, one matmul per product
    gradient) against ``jax.vjp`` through ``_wb_bwd`` (the XLA products
    and the Pallas window-attention backward in interpret mode), masked,
    fp32: atol 3e-5 and rtol 1e-4 against each gradient's scale."""
    Bn, C, H, nW = 4, 128, 4, 2
    args = _inputs(Bn, N, C, H, nW, seed=2 + N)
    mask = jnp.asarray(args[4])
    r = np.random.default_rng(9).standard_normal((Bn, N, C)).astype(
        np.float32)

    def f(x, wq, bq, bias, wp, bp):
        return jax_wb.window_block(x, wq, bq, bias, mask, wp, bp,
                                   num_heads=H)

    jargs = [jnp.asarray(a) for i, a in enumerate(args) if i != 4]
    want, vjp = jax.vjp(f, *jargs)
    wgrads = vjp(jnp.asarray(r))
    t = _port(args)
    leaves = [a.requires_grad_(True) for i, a in enumerate(t) if i != 4]
    x, wq, bq, bias, wp, bp = leaves
    got = wb.window_block(x, wq, bq, bias, t[4], wp, bp, num_heads=H)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=3e-5, rtol=1e-4)
    for name, leaf, w in zip(GRADS, leaves, wgrads):
        w = np.asarray(w)
        if name.startswith("w_"):
            w = w.T                              # nn.Linear layout
        np.testing.assert_allclose(leaf.grad.numpy(), w,
                                   atol=3e-5 * np.abs(w).max(), rtol=1e-4,
                                   err_msg=name)


# head dim 32 (every published Swin config), window 4: at 40 px the maps
# are 10 x 10 and 5 x 5, both padded to multiples of the window, so no
# block takes B9 on either side; stage 1 shifts (mask rows 9 per image),
# stage 2 is one window per image after padding, shifted
D32 = jax_swin.SwinConfig(embed_dim=64, depths=(2, 2), num_heads=(2, 4),
                          window_size=4, drop_path_rate=0.0)


def _count_flat(monkeypatch):
    """Count the port's calls of B7 and B8 (through the module attribute
    the Swin block reads)."""
    counts = {"b7": 0, "b8": 0}
    for key, name in (("b7", "window_block"), ("b8", "window_block_spatial")):
        fn = getattr(wb, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(wb, name, counted)
    return counts


def test_swin_with_the_flat_block_matches_jax(monkeypatch):
    """D32 at 40 px with ``VITX_FUSED_SPATIAL=0`` on both sides: the JAX
    model partitions the windows and runs the Pallas ``window_block`` in
    interpret mode (``VITX_FUSED_BLOCK=1``), the port runs B7's Function
    in all four blocks.  Features within atol 5e-5, rtol 2e-4 (the JAX
    package's model-level limits); every parameter's gradient of
    ``sum(features * r)`` within 1e-4 of max |JAX| of that gradient."""
    monkeypatch.setenv("VITX_FUSED_SPATIAL", "0")
    monkeypatch.setenv("VITX_FUSED_BLOCK", "1")
    monkeypatch.delenv("VITX_FUSED_FULL", raising=False)
    jmodel = jax_swin.SwinTransformer(D32, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, 40, 40, 3)).astype(
        np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]
    r = np.random.default_rng(4).standard_normal(
        (2, D32.feature_dim)).astype(np.float32)

    def loss(p):
        feats = jmodel.apply({"params": p}, jnp.asarray(x), True)
        return jnp.sum(feats * r), feats

    (_, want), wgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    wgrads = state_dict_from_jax(jax.tree.map(np.asarray, wgrads))
    model = swin.SwinTransformer(swin.SwinConfig(**D32.__dict__),
                                 image_size=40, dtype=torch.float32).eval()
    model.load_state_dict(state_dict_from_jax(params))
    counts = _count_flat(monkeypatch)
    got = model(torch.from_numpy(x))
    (got * torch.from_numpy(r)).sum().backward()
    assert counts == {"b7": 4, "b8": 0}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=5e-5, rtol=2e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(wgrads)
    for n, w in wgrads.items():
        err = (grads[n] - w).abs().max().item() / w.abs().max().item()
        assert err <= 1e-4, (n, err)


@pytest.mark.parametrize("flag,route", [("0", "b7"), ("", "b8"),
                                        ("1", "b8")])
def test_spatial_flag_picks_the_route(flag, route, monkeypatch):
    """Only ``VITX_FUSED_SPATIAL=0`` sends the blocks that do not take B9
    to B7; unset (or ``=1``) they stay on B8, the default."""
    monkeypatch.setenv("VITX_FUSED_SPATIAL", flag)
    model = swin.SwinTransformer(swin.SwinConfig(**D32.__dict__),
                                 image_size=40, dtype=torch.float32).eval()
    counts = _count_flat(monkeypatch)
    with torch.no_grad():
        model(torch.zeros((1, 40, 40, 3)))
    assert counts == {"b7": 0, "b8": 0, route: 4}


def test_cuda_tensor_never_takes_the_plain_version():
    """A tensor off the CPU reaches the kernel chain's checks, never the
    plain version: on the meta device the wrapper raises."""
    t = [torch.empty(s, device="meta") for s in (
        (4, 16, 64), (192, 64), (192,), (2, 16, 16), (64, 64), (64,))]
    with pytest.raises(ValueError, match="no window block"):
        wb.window_block(t[0], t[1], t[2], t[3], None, t[4], t[5],
                        num_heads=2)
