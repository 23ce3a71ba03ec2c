"""repro_torch.kernels.flash_attention against the JAX package's flash
attention.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the Pallas kernel in interpret mode
(``ops.flash_attention(..., interpret=True)``) and against
``ref.attention_ref`` on the same numpy inputs, over the sweep of
tests/test_kernels.py:17-44 (f32 / bf16 x causal / non-causal / window
64 x GQA (4,4), (4,2), (6,1)) plus head dim 80, at that file's
tolerances: 2e-5 for f32, 2e-2 for bf16 (the two sides round p to bf16
at other maxima).  The CUDA kernel is held against the plain version
where a card exists, at lengths that are not a multiple of its 64-row
tile.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, hq, hkv, d, dtype, seed=0):
    """numpy f32 inputs already rounded to ``dtype``, so both packages see
    the same values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]
    return [np.array(jnp.asarray(a).astype(dtype).astype(jnp.float32))
            for a in arrs]


def _port(arrs, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(_TORCH[dtype]) for a in arrs)
    out = flash_attention(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    return out.float().numpy()


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 16), (4, 2, 16), (6, 1, 16),
                                      (4, 2, 80)])
def test_plain_matches_pallas_interpret_and_reference(dtype, causal, window,
                                                      hq, hkv, d):
    arrs = _inputs(2, 128, hq, hkv, d, dtype)
    out = _port(arrs, dtype, causal=causal, window=window)
    jq, jk, jv = _jax(arrs, dtype)
    tol = TOL[dtype]
    pallas = ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                 block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas, np.float32),
                               atol=tol, rtol=tol)
    exp = ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(out, np.asarray(exp, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("s", [1, 37, 100])
def test_plain_takes_any_length(s):
    """The Pallas kernel asserts S % block == 0; the port takes any S >= 1
    (the serve engine prefills at the exact prompt length)."""
    arrs = _inputs(1, s, 4, 2, 16, "float32", seed=s)
    out = _port(arrs, "float32")
    exp = ref.attention_ref(*_jax(arrs, "float32"), causal=True)
    np.testing.assert_allclose(out, np.asarray(exp), atol=2e-5, rtol=2e-5)


def test_gqa_reads_kv_head_of_each_query_group():
    """Query head h reads kv head h // (Hq // Hkv): the same as repeating
    K/V first."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 24, 6, 2, 8,
                                                     "float32", seed=5))
    grouped = flash_attention(q, k, v)
    rep = flash_attention(q, k.repeat_interleave(3, dim=2),
                          v.repeat_interleave(3, dim=2))
    torch.testing.assert_close(grouped, rep, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("q,k,exc", [
    (torch.zeros(1, 4, 2, 16, dtype=torch.float64),
     torch.zeros(1, 4, 2, 16, dtype=torch.float64), TypeError),
    (torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16,
                                           dtype=torch.bfloat16), TypeError),
    (torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 2, 16), ValueError),
    (torch.zeros(1, 4, 2, 12), torch.zeros(1, 4, 2, 12), ValueError),
    (torch.zeros(1, 4, 2, 136), torch.zeros(1, 4, 2, 136), ValueError),
    (torch.zeros(1, 4, 2, 16), torch.zeros(1, 5, 2, 16), ValueError),
    (torch.zeros(4, 2, 16), torch.zeros(4, 2, 16), ValueError),
])
def test_rejects_what_the_kernel_does_not_take(q, k, exc):
    with pytest.raises(exc):
        flash_attention(q, k, k)


def test_cpu_tensors_never_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 2, 8,
                                                     "float32"))
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
@pytest.mark.parametrize("b,s,hq,hkv,d", [(2, 1, 4, 4, 16),
                                          (2, 37, 4, 2, 80),
                                          (1, 200, 16, 2, 128),
                                          (1, 1031, 6, 1, 64)])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, causal,
                                              window, b, s, hq, hkv, d):
    """Kernel vs plain version at FLASH tolerances, bytes identical from
    launch to launch, one launch counted per call."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, _TORCH[dtype])
               for a in _inputs(b, s, hq, hkv, d, dtype, seed=s))
    before = flash_attention.launches
    a = flash_attention(q, k, v, causal=causal, window=window)
    a2 = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    p = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert torch.equal(a, a2)
    tol = TOL[dtype]
    torch.testing.assert_close(a.float(), p.float(), atol=tol, rtol=tol)
