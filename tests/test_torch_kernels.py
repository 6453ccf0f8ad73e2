"""horovod_tpu_torch kernels: the plain versions against the JAX package's
Pallas kernels (run in interpret mode on the CPU, as
tests/test_pallas_kernels.py runs them), and the wrappers' CPU routing
(the CUDA kernels against their plain versions are in test_torch_cuda.py).

Tolerances: the BN statistics are fp32 sums of the same bf16 values taken in
another order, so they agree to fp32 rounding of the sum: |err| <= 1e-5 of
sum |terms| per channel. The pack is a copy and must be bitwise.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from horovod_tpu.ops.pallas_kernels import (bn_bwd_stats_pallas,
                                            bn_stats_pallas, pack_pallas)
from horovod_tpu_torch.ops import kernels as K

SUM_RTOL = 1e-5     # of sum |terms|: fp32 accumulation order only

# tests/test_pallas_kernels.py's (m, c) cases, its backward case, and more
# C=64 cases (ResNet-50's stem and first stage)
BN_CASES = [(1000, 256), (1000, 64), (512, 128), (777, 384), (900, 256),
            (2048, 64)]


def _bf16_pair(m, c, seed):
    """The same bf16 values as a jax array and a torch tensor."""
    rng = np.random.RandomState(seed)
    xj = jnp.asarray(rng.randn(m, c), jnp.bfloat16)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(torch.bfloat16)
    return xj, xt


def _close_to_sum(got, want, terms):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = SUM_RTOL * np.abs(np.asarray(terms, np.float64)).sum(0)
    assert np.all(np.abs(got - want) <= bound + 1e-6), \
        np.max(np.abs(got - want) - bound)


@pytest.mark.parametrize("m,c", BN_CASES)
def test_bn_stats_plain_matches_pallas(m, c):
    xj, xt = _bf16_pair(m, c, 0)
    s_ref, q_ref = bn_stats_pallas(xj)
    s, q = K.bn_stats_plain(xt)
    xf = xt.float().numpy()
    _close_to_sum(s, s_ref, xf)
    _close_to_sum(q, q_ref, xf * xf)


@pytest.mark.parametrize("m,c", BN_CASES)
def test_bn_bwd_stats_plain_matches_pallas(m, c):
    xj, xt = _bf16_pair(m, c, 1)
    dyj, dyt = _bf16_pair(m, c, 2)
    xf = xt.float().numpy()
    mean = xf.mean(0)
    invstd = (1.0 / (xf.std(0) + 1e-5)).astype(np.float32)
    s1_ref, s2_ref = bn_bwd_stats_pallas(dyj, xj, jnp.asarray(mean),
                                         jnp.asarray(invstd))
    s1, s2 = K.bn_bwd_stats_plain(dyt, xt, torch.from_numpy(mean),
                                  torch.from_numpy(invstd))
    dyf = dyt.float().numpy()
    _close_to_sum(s1, s1_ref, dyf)
    _close_to_sum(s2, s2_ref, dyf * (xf - mean) * invstd)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16", np.int32])
def test_pack_plain_matches_pallas(dtype):
    rng = np.random.RandomState(3)
    shapes = [(5,), (3, 4), (2, 2, 2), (1,), (64, 3, 3)]
    arrs = [jnp.asarray(rng.randn(*s) * 10, dtype) for s in shapes]
    want = np.asarray(pack_pallas(arrs)).astype(np.float32)
    got = K.pack_plain([torch.tensor(np.asarray(a).astype(np.float32))
                        for a in arrs])
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_the_plain_path_on_cpu():
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(300, 64), dtype=torch.float32)
    dy = torch.tensor(rng.randn(300, 64), dtype=torch.float32)
    mean, invstd = x.mean(0), 1.0 / (x.std(0) + 1e-5)
    before = K.launch_counts()
    for a, b in zip(K.bn_stats(x), K.bn_stats_plain(x)):
        assert torch.equal(a, b)
    for a, b in zip(K.bn_bwd_stats(dy, x, mean, invstd),
                    K.bn_bwd_stats_plain(dy, x, mean, invstd)):
        assert torch.equal(a, b)
    ts = [x[:7], dy[3], x[:2, :5].contiguous()]
    assert torch.equal(K.pack(ts), K.pack_plain(ts))
    assert K.launch_counts() == before   # plain runs are no launches


def test_pack_rejects_mixed_dtypes_and_empty():
    with pytest.raises(ValueError):
        K.pack([torch.zeros(3), torch.zeros(3, dtype=torch.float64)])
    with pytest.raises(ValueError):
        K.pack([])


@pytest.mark.parametrize("m,c", [(802816, 64), (200704, 256),
                                 (12544, 1024), (3136, 2048)])
def test_bn_chunks_fill_an_h100_at_resnet50_shapes(m, c):
    """At least 2 blocks per SM of a 132-SM card at every ResNet-50 shape
    (batch 64), including the small-M layers."""
    vcols = c // 8
    col_tiles = -(-vcols // min(vcols, 256))
    assert K.bn_chunks(m, c, 2, 132) * col_tiles >= 2 * 132


def test_bn_chunks_keep_rows_per_thread_on_tiny_inputs():
    assert K.bn_chunks(10, 64, 4, 132) == 1
    assert K.bn_chunks(0, 64, 2, 132) == 1
