"""repro_torch.kernels.window_reduce against the JAX package's
window_reduce.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against ``repro.kernels.ref.window_reduce_ref`` and the Pallas kernel in
interpret mode (``ops.window_reduce(..., interpret=True)``) on the shapes
of tests/test_kernels.py.  Counts and max are compared exactly; sum and
sumsq at rtol/atol 1e-5, the bar tests/test_kernels.py sets, since the
float sums are taken in another order.  The CUDA kernel is held against
the plain version where a card exists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels.window_reduce import (window_reduce,
                                               window_reduce_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(vals, segs, s):
    return window_reduce(vals, segs, s, device="cpu").numpy()


def _check(out, exp):
    exp = np.asarray(exp)
    assert out.shape == exp.shape and out.dtype == np.float32
    np.testing.assert_array_equal(out[:, 0], exp[:, 0])      # count
    np.testing.assert_array_equal(out[:, 3], exp[:, 3])      # max
    np.testing.assert_allclose(out[:, 1:3], exp[:, 1:3], **TOL)


@pytest.mark.parametrize("seed", range(10))
def test_window_reduce_random_layouts(seed):
    """Randomized (key, window) layouts, -1 padding included."""
    rng = np.random.default_rng(seed)
    n, s = int(rng.integers(1, 3001)), int(rng.integers(1, 501))
    vals = (rng.normal(size=n) * 10).astype(np.float32)
    segs = rng.integers(-1, s, size=n).astype(np.int32)
    out = _port(vals, segs, s)
    _check(out, ref.window_reduce_ref(vals, segs, s))
    _check(out, ops.window_reduce(jnp.asarray(vals), jnp.asarray(segs), s,
                                  interpret=True))


@pytest.mark.parametrize("block_s,block_n", [(8, 8), (128, 1024), (32, 256)])
def test_window_reduce_block_shapes(block_s, block_n):
    rng = np.random.default_rng(0)
    n, s = 2048, 300
    vals = rng.normal(size=n).astype(np.float32)
    segs = rng.integers(0, s, size=n).astype(np.int32)
    exp = ops.window_reduce(jnp.asarray(vals), jnp.asarray(segs), s,
                            block_s=block_s, block_n=block_n, interpret=True)
    _check(_port(vals, segs, s), exp)


def test_window_reduce_empty_segments_and_lanes():
    out = _port([2.0, 3.0, -1.0], [0, 0, 2], 4)
    np.testing.assert_allclose(out[0], [2.0, 5.0, 13.0, 3.0])  # cnt/sum/sq/max
    np.testing.assert_allclose(out[2], [1.0, -1.0, 1.0, -1.0])
    assert out[1][0] == 0.0 and out[1][3] == -np.inf            # empty segment
    assert out[3][0] == 0.0 and out[3][3] == -np.inf
    _check(out, ops.window_reduce(jnp.asarray([2.0, 3.0, -1.0], jnp.float32),
                                  jnp.asarray([0, 0, 2], jnp.int32), 4,
                                  interpret=True))
    # zero events: the defined empty result, and no launch
    before = window_reduce.launches
    empty = window_reduce(np.zeros(0, np.float32), np.zeros(0, np.int32), 2,
                          device="cpu")
    assert empty.shape == (2, 4)
    assert (empty[:, 0] == 0).all() and (empty[:, 3] == -np.inf).all()
    assert window_reduce.launches == before


def test_window_reduce_ignores_out_of_range_ids():
    """Ids outside [0, S) are dropped, as both JAX versions drop them."""
    vals = np.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0], np.float32)
    segs = np.array([0, -1, 3, -7, 5, 1], np.int32)
    out = _port(vals, segs, 3)
    np.testing.assert_allclose(out[:, 0], [1.0, 1.0, 0.0])
    np.testing.assert_allclose(out[:, 1], [1.0, 32.0, 0.0])
    _check(out, ref.window_reduce_ref(vals, segs, 3))
    _check(out, ops.window_reduce(jnp.asarray(vals), jnp.asarray(segs), 3,
                                  interpret=True))


def _nan_case():
    """A NaN on lane 1 of a warp's second round, beside a clean segment."""
    vals = np.ones(41, np.float32)
    vals[33], vals[40] = np.nan, 7.0
    return vals, np.array([0] * 40 + [1], np.int32), 3


def test_window_reduce_propagates_nan():
    """A NaN value makes its segment's sums and max NaN, as in both JAX
    versions; counts stay exact and other segments are untouched."""
    vals, segs, s = _nan_case()
    out = _port(vals, segs, s)
    exp = np.asarray(ref.window_reduce_ref(vals, segs, s))
    np.testing.assert_array_equal(out, exp)                  # NaN == NaN here
    np.testing.assert_array_equal(out, np.asarray(ops.window_reduce(
        jnp.asarray(vals), jnp.asarray(segs), s, interpret=True)))
    assert out[0, 0] == 40 and np.isnan(out[0, 1:]).all()
    np.testing.assert_array_equal(out[1], [1, 7, 49, 7])


def test_window_reduce_tensor_input_stays_on_its_device():
    vals = torch.tensor([1.5, -2.5, 3.0])
    segs = torch.tensor([1, 1, 0], dtype=torch.int32)
    before = window_reduce.launches
    out = window_reduce(vals, segs, 2)        # default device: tensors stay
    assert out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(),
                               [[1, 3.0, 9.0, 3.0], [2, -1.0, 8.5, 1.5]])
    assert window_reduce.launches == before   # CPU tensors never launch


@pytest.mark.parametrize("vals,segs,exc", [
    (torch.zeros(3, dtype=torch.float64), torch.zeros(3, dtype=torch.int32),
     TypeError),
    (torch.zeros(3), torch.zeros(3, dtype=torch.int64), TypeError),
    (torch.zeros(3), torch.zeros(2, dtype=torch.int32), ValueError),
    (torch.zeros(2, 2), torch.zeros(2, 2, dtype=torch.int32), ValueError),
])
def test_window_reduce_rejects_bad_tensors(vals, segs, exc):
    with pytest.raises(exc):
        window_reduce(vals, segs, 4)


def test_plain_version_matches_reference_on_a_day_like_layout():
    """The replay shape in miniature: many events over few slots."""
    rng = np.random.default_rng(3)
    n, s = 20_000, 48
    vals = rng.lognormal(size=n).astype(np.float32)
    segs = rng.integers(0, s, size=n).astype(np.int32)
    out = window_reduce_plain(torch.from_numpy(vals), torch.from_numpy(segs),
                              s).numpy()
    _check(out, ref.window_reduce_ref(vals, segs, s))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(3, 4), (1, 1), (200_000, 4096),
                                 (100_000, 256), (50_000, 1_000_000)])
def test_kernel_matches_plain_version_on_card(cuda_device, n, s):
    """Count and max exact, sums to 1e-4 of the segment's absolute sum
    (atomics order the plain version's sums too), bytes identical from
    launch to launch."""
    rng = np.random.default_rng(n + s)
    vals = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    segs = torch.from_numpy(rng.integers(-1, s, size=n).astype(np.int32))
    v, g = vals.to(cuda_device), segs.to(cuda_device)
    before = window_reduce.launches
    a = window_reduce(v, g, s)
    b = window_reduce(v, g, s)
    torch.cuda.synchronize()
    assert window_reduce.launches == before + 2
    p = window_reduce_plain(v, g, s)
    absum = window_reduce_plain(v.abs(), g, s)[:, 1]
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a[:, 0], p[:, 0]) and torch.equal(a[:, 3], p[:, 3])
    assert ((a[:, 1] - p[:, 1]).abs() <= 1e-4 * absum + 1e-6).all()
    assert ((a[:, 2] - p[:, 2]).abs() <= 1e-4 * p[:, 2] + 1e-6).all()


@pytest.mark.cuda
def test_kernel_propagates_nan_on_card(cuda_device):
    """The kernel's max keeps a NaN through the lane fold and the shuffle
    tree, as the plain version does; compared exactly, NaN equal to NaN."""
    vals, segs, s = _nan_case()
    out = window_reduce(torch.from_numpy(vals).to(cuda_device),
                        torch.from_numpy(segs).to(cuda_device), s)
    exp = window_reduce_plain(torch.from_numpy(vals), torch.from_numpy(segs),
                              s)
    np.testing.assert_array_equal(out.cpu().numpy(), exp.numpy())
