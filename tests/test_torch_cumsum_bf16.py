"""The 'sorted' reduction's prefix sum on bfloat16 payloads, against the JAX
package.

``blocked_cumsum`` (CPU tensors: its plain version, which widens the
payload to float32) and ``sorted_segment_sum`` take a bfloat16 payload and
return float32, as ``se3conv3d_tpu.ops.pallas.segsum`` does (its Pallas
``_cumsum_kernel`` in interpret mode: a triangular product of the bfloat16
block with float32 accumulation).  Both sides get the same bfloat16 values
(float32 numpy inputs from a seed, rounded to nearest even by each
framework) and sum them in float32 in other orders, so they agree with each
other and with a float64 sum of the same values within ``1e-5 * max|sum|``
(``CUMSUM_RTOL``, the kernel's bound in ``chip_smoke.py``); a segment sum is
a prefix difference, which carries about ``eps * |prefix|`` at each end, so
``256 eps * max|prefix|`` (``SEGSUM_EPS_FACTOR``).  The CUDA kernel on
bfloat16 payloads is held against the same plain version on the card
(``tests/test_torch_kernel_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3conv3d_tpu.ops.pallas import segsum as jsegsum
from se3conv3d_tpu_torch.kernels import segsum

torch.set_num_threads(2)

CUMSUM_RTOL = 1e-5
SEGSUM_EPS_FACTOR = 256
EPS = float(np.finfo(np.float32).eps)


def _bf16_pair(x):
    """The same bfloat16 values in each framework, and as float64."""
    ours, theirs = torch.from_numpy(x).bfloat16(), jnp.asarray(x).astype(jnp.bfloat16)
    exact = ours.double().numpy()
    np.testing.assert_array_equal(exact, np.asarray(theirs, np.float64))
    return ours, theirs, exact


@pytest.mark.parametrize("e,c,blk", [(16, 8, 8), (700, 64, 128), (1000, 128, 256), (513, 33, 128),
                                     (3000, 20, 256), (257, 5, 256)])
def test_bf16_blocked_cumsum_matches_jax_pallas_kernel(e, c, blk):
    x = np.random.default_rng(e + c).standard_normal((e, c)).astype(np.float32)
    ours_in, theirs_in, exact = _bf16_pair(x)
    before = segsum.blocked_cumsum.launches
    ours = segsum.blocked_cumsum(ours_in)
    assert segsum.blocked_cumsum.launches == before  # CPU tensors launch no kernel
    assert ours.dtype == torch.float32 and ours.shape == (e, c)
    theirs = np.asarray(jsegsum.blocked_cumsum(theirs_in, block=blk))
    assert theirs.dtype == np.float32
    want = np.cumsum(exact, axis=0)
    bound = CUMSUM_RTOL * np.abs(want).max()
    assert np.abs(ours.numpy() - theirs).max() <= bound
    assert np.abs(ours.numpy() - want).max() <= bound
    # the plain version at the JAX call's block height as well
    assert np.abs(segsum.blocked_cumsum_reference(ours_in, blk).numpy() - theirs).max() <= bound


def test_bf16_blocked_cumsum_is_batched_over_the_leading_axis():
    x = np.random.default_rng(3).standard_normal((3, 600, 24)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    batched = segsum.blocked_cumsum(xb)
    assert batched.dtype == torch.float32 and batched.shape == x.shape
    for i in range(3):
        assert torch.equal(batched[i], segsum.blocked_cumsum(xb[i]))


@pytest.mark.parametrize("e,c,n", [(2048, 64, 300), (5000, 20, 1200)])
def test_bf16_sorted_segment_sum_matches_jax_and_a_float64_oracle(e, c, n):
    rng = np.random.default_rng(e)
    segs = np.sort(rng.integers(0, n, e)).astype(np.int32)
    data = rng.standard_normal((e, c)).astype(np.float32)
    rs = np.searchsorted(segs, np.arange(n), side="left").astype(np.int32)
    re = np.searchsorted(segs, np.arange(n), side="right").astype(np.int32)
    assert (rs == re).any()  # some empty segments
    ours_in, theirs_in, exact = _bf16_pair(data)
    oracle = np.zeros((n, c), np.float64)
    np.add.at(oracle, segs, exact)
    ours = segsum.sorted_segment_sum(ours_in, torch.from_numpy(rs).long(), torch.from_numpy(re).long())
    assert ours.dtype == torch.float32 and ours.shape == (n, c)
    theirs = np.asarray(jsegsum.sorted_segment_sum(theirs_in, jnp.asarray(rs), jnp.asarray(re)))
    bound = SEGSUM_EPS_FACTOR * EPS * np.abs(np.cumsum(exact, axis=0)).max()
    assert np.abs(ours.numpy() - oracle).max() <= bound
    assert np.abs(ours.numpy() - theirs).max() <= bound


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.int32])
def test_blocked_cumsum_rejects_other_payloads_on_the_cpu_too(dtype):
    with pytest.raises(TypeError):
        segsum.blocked_cumsum(torch.zeros(10, 4, dtype=dtype))
