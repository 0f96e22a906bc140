"""Parity of the port's OS I-S baseline (`repro_torch.core.ozaki1`) with
`repro.core.ozaki1`.

The same numpy operands, drawn from the seeded `rng` fixture, go through
both packages on the CPU.  Tolerance: none; the outputs are compared by
their bits (a zero's sign counts).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import phi_matrix

import repro.core.ozaki1 as jo1
import repro_torch.core.ozaki1 as to1

M, K, N = 48, 192, 40  # tests/test_core_gemm.py's shape
DTYPES = (np.float32, np.float64, np.complex64, np.complex128)


def _bits(x) -> np.ndarray:
    x = np.ascontiguousarray(np.asarray(x))
    if np.iscomplexobj(x):
        x = np.stack([x.real, x.imag], axis=-1)
    return x.view({4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


def _both(a, b, s):
    if np.iscomplexobj(a):
        want = jo1.ozaki1_cgemm(jnp.asarray(a), jnp.asarray(b), s)
        got = to1.ozaki1_cgemm(torch.from_numpy(a), torch.from_numpy(b), s, device="cpu")
    else:
        want = jo1.ozaki1_gemm(jnp.asarray(a), jnp.asarray(b), s)
        got = to1.ozaki1_gemm(torch.from_numpy(a), torch.from_numpy(b), s, device="cpu")
    want = np.asarray(want)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    return got


@pytest.mark.parametrize("s", [5, 9])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_ozaki1_bitwise(rng, dtype, s):
    a = phi_matrix(rng, (M, K), 1.0, dtype)
    b = phi_matrix(rng, (K, N), 1.0, dtype)
    a[3] = 0  # a zero row keeps exponent 0, as in the reference
    _both(a, b, s)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=lambda d: np.dtype(d).name)
def test_ozaki1_batched_and_ragged(rng, dtype):
    """A leading batch dim (broadcast against a 2D operand) and a ragged
    shape: every matrix pair scaled on its own rows and columns."""
    a = phi_matrix(rng, (2, 17, 33), 2.0, dtype)
    b = phi_matrix(rng, (33, 7), 2.0, dtype)
    got = _both(a, b, 5)
    assert tuple(got.shape) == (2, 17, 7)


def test_int8_gemm_count_and_k_limit():
    assert [to1.int8_gemm_count(s) for s in (1, 5, 9)] == [jo1.int8_gemm_count(s) for s in (1, 5, 9)]
    assert to1.int8_gemm_count(9) == 45 and to1.SLICE_BITS == jo1.SLICE_BITS
    a = torch.zeros((2, (1 << 17) + 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="exact-int32"):
        to1.int8_product(a, a.T)
    x = torch.zeros((2, (1 << 17) + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="exact-int32"):
        to1.ozaki1_gemm(x, x.T, 2, device="cpu")


def test_int8_product_padding_is_exact(rng):
    """The card's route pads to `_int_mm`'s shapes with zeros; the padded
    product, cut back, is the exact one (checked here on the CPU)."""
    a = torch.from_numpy(rng.integers(-127, 128, (12, 61)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (61, 45)).astype(np.int8))
    pa = torch.nn.functional.pad(a, (0, 3, 0, 12))
    pb = torch.nn.functional.pad(b, (0, 3, 0, 3))
    want = a.long() @ b.long()
    assert torch.equal(to1.int8_product(pa, pb)[:12, :45].long(), want)
    assert torch.equal(to1.int8_product(a, b).long(), want)
