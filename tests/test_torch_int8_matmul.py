"""The port's W8A16 product against the JAX package's.

``quantize_int8`` must be bit-exact with the JAX function, and
``int8_matmul_ref`` (the plain version of the CUDA kernel: the scale
applied to the f32-accumulated product) must compute what the JAX
``int8_matmul`` computes with its Pallas kernel in interpret mode, at a
ragged N.  Tolerances: f32 within 1e-5 of the output's scale (the order of
f32 sums); bf16 outputs within 1 bf16 ulp of each value (the rounding of a
sum taken in another order may flip).  CPU tensors never launch the kernel.
Which kernel a call on the card takes (the TMA + wgmma kernel, with 64- or
128-column tiles, or the split-K product) is decided in Python from the
dtype, the shapes and the addresses, and is checked here in pure Python.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.ops.pallas.int8_matmul import int8_matmul as jax_int8_matmul
from blt_vqg_tpu.ops.pallas.int8_matmul import quantize_int8 as jax_quantize_int8
from blt_vqg_tpu_torch.ops.kernels import int8_matmul as tim


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quantize_int8_bit_exact():
    r = np.random.RandomState(0)
    w = (r.randn(16, 300) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                                    # amax 0 column
    w[:6, 5] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]    # exact halves
    w[6:, 5] = 0.0
    w8_j, s_j = jax_quantize_int8(jnp.asarray(w))
    w8_t, s_t = tim.quantize_int8(torch.from_numpy(w))
    assert w8_t.dtype == torch.int8 and tuple(s_t.shape) == (300,)
    np.testing.assert_array_equal(w8_t.numpy(), np.asarray(w8_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(w8_t[:6, 5].numpy(), [127, 0, 2, 2, 0, -2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(8, 128, 300), (5, 96, 130)])
def test_ref_matches_jax_int8_matmul(dtype, m, k, n):
    r = np.random.RandomState(m + n)
    x = r.randn(m, k).astype(np.float32)
    w8, s = tim.quantize_int8(torch.from_numpy(
        (r.randn(k, n) * 0.05).astype(np.float32)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    want = np.asarray(jax_int8_matmul(
        xj, jnp.asarray(w8.numpy()), jnp.asarray(s.numpy()), tile_n=128,
        interpret=True)).astype(np.float32)
    before = tim.int8_matmul.launches
    got = tim.int8_matmul(xt, w8, s)
    assert tim.int8_matmul.launches == before          # CPU: plain version
    assert got.dtype == xt.dtype and tuple(got.shape) == (m, n)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                                   rtol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


# (dtype, M, K, N, 16-byte aligned, SMs) -> block columns (0: split-K)
TMA_CASES = [
    ("bfloat16", 64, 1024, 12000, True, 132, 128),  # the vocab head
    ("bfloat16", 256, 1024, 2048, True, 132, 64),   # FFN in at beam width
    ("bfloat16", 5, 1024, 12000, True, 132, 128),   # ragged M
    ("bfloat16", 130, 512, 4096, True, 132, 128),   # three row tiles
    ("bfloat16", 1, 8, 16, True, 132, 64),          # the least TMA takes
    ("bfloat16", 64, 1024, 12000, True, 264, 64),   # more SMs: 64 columns
    ("bfloat16", 3, 40, 300, True, 132, 0),         # N % 16
    ("bfloat16", 70, 96, 1000, True, 132, 0),       # N % 16
    ("bfloat16", 64, 1020, 12000, True, 132, 0),    # K % 8
    ("bfloat16", 64, 1024, 12000, False, 132, 0),   # an unaligned view
    ("bfloat16", 0, 1024, 2048, True, 132, 0),      # no rows
    ("float32", 64, 1024, 12000, True, 132, 0),     # an f32 product
]


@pytest.mark.parametrize("case", TMA_CASES,
                         ids=[f"{c[0][:4]}-{c[1]}x{c[2]}x{c[3]}"
                              f"{'' if c[4] else '-unaligned'}-sm{c[5]}"
                              for c in TMA_CASES])
def test_tma_path_by_shape(case):
    dtype, m, k, n, aligned, sms, want = case
    assert tim.tma_columns(getattr(torch, dtype), m, k, n, aligned, sms) == want
