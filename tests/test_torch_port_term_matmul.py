"""The port's fused term matmul (f32 mode) against the JAX package's."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu_torch.kernels import term_matmul as tm

jm = importlib.import_module("tq_tpu.kernels.term_matmul")


@pytest.mark.parametrize("M,K,N", [(8, 32, 16), (13, 100, 7), (130, 300, 70)])
@pytest.mark.parametrize("bits,terms", [(8, 3), (4, 2), (9, 9)])
def test_plain_version_matches_jax_f32(rng, M, K, N, bits, terms):
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    sf = np.float32(0.03)
    want = np.asarray(jm.term_matmul(jnp.asarray(x), jnp.asarray(w),
                                     jnp.float32(sf), bits, terms,
                                     bm=64, bk=128, bn=128))
    got = tm.term_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.tensor(sf), bits, terms)
    # Float32 sums taken in another order: tests/test_term_matmul.py's
    # CPU tolerance.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(
        got, tm.term_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                torch.tensor(sf), bits, terms),
        rtol=0, atol=0)


def test_cpu_tensor_counts_no_launch(rng):
    x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    tm.term_matmul(x, w, 0.1, 6, 2)
    assert tm.term_matmul.launches == {"f32": 0}


@pytest.mark.parametrize("kwargs,w_dtype,match", [
    (dict(bf16=True), torch.float32, "bf16"),
    (dict(int8=True), torch.float32, "int8"),
    (dict(quantize_x=False), torch.float32, "raw-input"),
    (dict(), torch.int8, "integer weights"),
    (dict(), torch.int16, "integer weights"),
])
def test_unported_modes_raise(kwargs, w_dtype, match):
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 3, dtype=w_dtype)
    with pytest.raises(NotImplementedError, match=match):
        tm.term_matmul(x, w, 0.1, 6, 2, **kwargs)


def test_packed_weights_raise():
    packed = (torch.zeros(8, 3, dtype=torch.int8),
              torch.zeros(1, 3, dtype=torch.int8), torch.tensor(1.0))
    with pytest.raises(NotImplementedError, match="packed"):
        tm.term_matmul(torch.zeros(4, 8), packed, 0.1, 8, 2)


def test_rejects_bad_arguments():
    with pytest.raises(ValueError, match="w_sf"):
        tm.term_matmul(torch.zeros(4, 8), torch.zeros(8, 3), 0.1, 6, 2,
                       w_sf=torch.tensor(1.0))
    with pytest.raises(ValueError, match="x \\(M, K\\)"):
        tm.term_matmul(torch.zeros(4, 8), torch.zeros(7, 3), 0.1, 6, 2)
