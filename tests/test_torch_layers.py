"""repro_torch.models.layers against repro.models.layers on the same numpy
inputs.

f32 inputs are held at 1e-5 (the same arithmetic in another library);
bf16 at 2e-2, the bf16 bar of tests/test_kernels.py (the two libraries
round the bf16 products at other places).  SwiGLU feeds both the same
(in, out) weights: the port's ``nn.Linear`` holds them transposed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.models import layers as JL
from repro_torch.models import layers as L

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """One numpy array as (jax array, torch tensor) of ``dtype`` with the
    same values."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TORCH[dtype])
    return j, t


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(2, 7, 64)) * 3, dtype)
    jw, tw = _pair(rng.normal(size=(64,)), dtype)
    out = L.rms_norm(tx, tw, 1e-6)
    assert out.dtype == tx.dtype
    _close(out, JL.rms_norm(jx, jw, 1e-6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_half_split(dtype, theta):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.normal(size=(2, 9, 3, 16)), dtype)
    pos = rng.integers(0, 4000, size=(2, 9))
    out = L.apply_rope(tx, torch.from_numpy(pos), theta)
    _close(out, JL.apply_rope(jx, jnp.asarray(pos), theta), dtype)
    np.testing.assert_allclose(L.rope_inv_freq(16, theta).numpy(),
                               np.asarray(JL.rope_inv_freq(16, theta)),
                               rtol=1e-6)


def test_repeat_kv_order():
    x = np.arange(2 * 4 * 2 * 3).reshape(2, 4, 2, 3)
    out = L.repeat_kv(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(JL.repeat_kv(jnp.asarray(x), 3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention(dtype, window):
    """One query per row against a cache with a valid length per row;
    GQA group 2; positions past the length must not count."""
    rng = np.random.default_rng(2)
    b, s, hq, hkv, d = 3, 12, 4, 2, 16
    jq, tq = _pair(rng.normal(size=(b, 1, hq, d)), dtype)
    kc = rng.normal(size=(b, s, hkv, d))
    vc = rng.normal(size=(b, s, hkv, d))
    length = np.array([1, 7, 12], np.int32)
    kc[0, 1:] = 1e4                     # garbage past the valid length
    jk, tk = _pair(kc, dtype)
    jv, tv = _pair(vc, dtype)
    out = L.decode_attention(tq, tk, tv, torch.from_numpy(length),
                             window=window)
    assert out.shape == (b, 1, hq, d) and out.dtype == tq.dtype
    _close(out, JL.decode_attention(jq, jk, jv, jnp.asarray(length),
                                    window=window), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    rng = np.random.default_rng(3)
    d, f = 32, 80
    jx, tx = _pair(rng.normal(size=(2, 5, d)), dtype)
    ws = [rng.normal(size=shape) / np.sqrt(shape[0])
          for shape in ((d, f), (d, f), (f, d))]
    pairs = [_pair(w, dtype) for w in ws]

    def linear(tw):
        lin = nn.Linear(tw.shape[0], tw.shape[1], bias=False,
                        dtype=tw.dtype)
        lin.weight = nn.Parameter(tw.t().contiguous(), requires_grad=False)
        return lin

    out = L.swiglu(tx, *(linear(t) for _, t in pairs))
    _close(out, JL.swiglu(jx, *(j for j, _ in pairs)), dtype)


def test_flash_attention_layer_takes_unrepeated_kv():
    """The layer hands unrepeated K/V to the kernel wrapper; it equals the
    JAX layer fed repeated K/V (its contract)."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 40, 2, 16)).astype(np.float32)
    out = L.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=True)
    exp = JL.flash_attention(jnp.asarray(q),
                             JL.repeat_kv(jnp.asarray(k), 2),
                             JL.repeat_kv(jnp.asarray(v), 2), causal=True,
                             chunk=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=2e-5,
                               rtol=2e-5)
