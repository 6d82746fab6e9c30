"""Ozaki error-free-transformation f64 matmul (ops/df64.py).

The double-word trick of SURVEY hard part (d): f64-grade products from
exact bf16 matmul passes.  Accuracy target here is well beyond anything the
f64-parity solve path needs (~1e-9); the scheme itself lands at ~1e-13
relative to the row-max x col-max scale.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from cwbnwp_letkf_tpu.ops.df64 import ozaki_matmul, ozaki_matvec


@pytest.mark.parametrize("shape_a,shape_b", [
    ((64, 40, 40), (64, 40, 40)),
    ((8, 96, 96), (8, 96, 96)),
    ((40, 40), (40, 40)),
    ((5, 24, 17), (5, 17, 3)),     # rectangular + small N
])
def test_matches_f64_gemm(shape_a, shape_b):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(shape_a)
    b = rng.standard_normal(shape_b)
    c = np.asarray(ozaki_matmul(jnp.asarray(a), jnp.asarray(b)))
    ref = a @ b
    assert c.dtype == np.float64
    err = np.abs(c - ref).max() / np.abs(ref).max()
    assert err < 1e-12, err


def test_ill_scaled_rows_and_columns():
    """Per-row/col power-of-two scaling keeps wild dynamic ranges exact."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 40, 40))
    a *= 10.0 ** rng.integers(-12, 12, size=(16, 40, 1)).astype(np.float64)
    b = rng.standard_normal((16, 40, 40))
    b *= 10.0 ** rng.integers(-12, 12, size=(16, 1, 40)).astype(np.float64)
    c = np.asarray(ozaki_matmul(jnp.asarray(a), jnp.asarray(b)))
    ref = a @ b
    # relative to each entry's own row-max * col-max bound
    bound = (np.abs(a).max(-1, keepdims=True)
             * np.abs(b).max(-2, keepdims=True))
    err = (np.abs(c - ref) / bound).max()
    assert err < 1e-12, err


def test_zero_rows_and_exact_zero():
    a = np.zeros((4, 8, 8))
    b = np.ones((4, 8, 8))
    c = np.asarray(ozaki_matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(c, 0.0)


def test_cancellation_residual():
    """The parity use case: I - A @ inv(A) needs ABSOLUTE f64 accuracy.

    Software-f32 products would leave ~1e-7 absolute garbage here; the
    EFT path reproduces f64's tiny residual.
    """
    rng = np.random.default_rng(2)
    k = 40
    y = rng.standard_normal((8, k, 120)) * 0.4
    a = y @ np.transpose(y, (0, 2, 1)) + 30.0 * np.eye(k)
    ainv = np.linalg.inv(a)
    p = np.asarray(ozaki_matmul(jnp.asarray(a), jnp.asarray(ainv)))
    resid_eft = np.abs(p - np.eye(k)).max()
    resid_f64 = np.abs(a @ ainv - np.eye(k)).max()
    assert resid_eft < max(10 * resid_f64, 1e-12), (resid_eft, resid_f64)


def test_matvec():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 40, 40))
    x = rng.standard_normal((16, 40))
    got = np.asarray(ozaki_matvec(jnp.asarray(a), jnp.asarray(x)))
    ref = np.einsum("bij,bj->bi", a, x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12


def test_k_bound_enforced():
    a = jnp.zeros((2, 300, 300))
    with pytest.raises(ValueError):
        ozaki_matmul(a, a)
