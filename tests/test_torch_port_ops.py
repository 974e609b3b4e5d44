"""The port's HESE and term-reveal ops against the JAX package, bit for bit.

The same numpy inputs go through ``tq_tpu`` (on the CPU; its Pallas
``tr_quantize`` runs in interpret mode there) and ``tq_tpu_torch`` (the
plain versions a CPU tensor takes).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu_torch.kernels import tr_quantize as tk
from tq_tpu_torch.ops import hese as these
from tq_tpu_torch.ops import term_reveal as ttr

# The JAX package's ``__init__`` files re-export functions under their
# modules' names, so import the modules themselves.
jk = importlib.import_module("tq_tpu.kernels.tr_quantize")
jhese = importlib.import_module("tq_tpu.ops.hese")
jtr = importlib.import_module("tq_tpu.ops.term_reveal")


def _boundary_grid(bits: int, sf: float) -> np.ndarray:
    """Every q < 2**bits as +-q*sf, the rounding boundaries (q+0.5)*sf and
    their float32 neighbours."""
    q = np.arange(2**bits, dtype=np.float32)
    sf = np.float32(sf)
    half = ((q + np.float32(0.5)) * sf).astype(np.float32)
    x = np.concatenate([q * sf, half, np.nextafter(half, np.float32(np.inf)),
                        np.nextafter(half, np.float32(0))]).astype(np.float32)
    return np.concatenate([x, -x])


@pytest.mark.parametrize("bits", range(1, 13))
def test_hese_digit_planes_exhaustive(bits):
    q = np.arange(2**bits, dtype=np.int32)
    want = np.asarray(jhese.hese_digit_planes(jnp.asarray(q), bits))
    got = these.hese_digit_planes(torch.from_numpy(q), bits).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(these.hese_digit_planes_np(q, bits), want)
    np.testing.assert_array_equal(
        these.binary_digit_planes(torch.from_numpy(q), bits).numpy(),
        np.asarray(jhese.binary_digit_planes(jnp.asarray(q), bits)))
    np.testing.assert_array_equal(
        these.hese_terms_count(torch.from_numpy(q), bits).numpy(),
        np.asarray(jhese.hese_terms_count(jnp.asarray(q), bits)))
    np.testing.assert_array_equal(these.transition_merge_terms_np(q),
                                  jhese.transition_merge_terms_np(q))
    # The planes reconstruct q.
    np.testing.assert_array_equal((got << np.arange(bits + 1)).sum(-1), q)


def test_max_hese_terms_tight_and_equal():
    for bits in range(1, 15):
        counts = np.abs(these.hese_digit_planes_np(np.arange(1 << bits),
                                                   bits)).sum(-1)
        assert counts.max() == tk.max_hese_terms(bits) \
            == jk.max_hese_terms(bits), bits


def _jax_all_budgets(fn, x, sf, bits, group_size, budgets, axis, mode):
    """``fn`` at every budget, compiled once.  ``sf`` stays an argument: as
    a constant, XLA would turn ``|x| / sf`` into ``|x| * (1 / sf)``."""
    run = jax.jit(lambda v, s: [fn(v, s, bits, group_size, b, axis=axis,
                                   keep_mode=mode) for b in budgets])
    return [np.asarray(a) for a in run(jnp.asarray(x), jnp.float32(sf))]


@pytest.mark.parametrize("bits", range(1, 10))
@pytest.mark.parametrize("mode", ["largest", "serial"])
def test_elementwise_every_q_and_budget(bits, mode):
    """Every q < 2**bits (and its rounding boundaries) at every budget,
    through the JAX op and the JAX kernel, against the port's plain
    version, its int variant and its ``term_reveal``."""
    sf = np.float32(0.0371)
    x = _boundary_grid(bits, sf)
    budgets = list(range(0, tk.max_hese_terms(bits) + 2))
    want_op = _jax_all_budgets(jtr.term_reveal, x, sf, bits, 1, budgets, 0,
                               mode)
    want_kernel = _jax_all_budgets(jk.tr_quantize, x, sf, bits, 1, budgets,
                                   0, mode)
    xt, sft = torch.from_numpy(x), torch.tensor(sf)
    for b, wo, wk in zip(budgets, want_op, want_kernel):
        got = tk.tr_quantize_ref(xt, sft, bits, 1, b, 0, mode).numpy()
        np.testing.assert_array_equal(got, wo, err_msg=f"budget {b}")
        np.testing.assert_array_equal(got, wk, err_msg=f"budget {b}")
        np.testing.assert_array_equal(
            ttr.term_reveal(xt, sft, bits, 1, b, 0, mode).numpy(), wo)
        # The int variant is the dequantized value over sf, exactly.
        got_int = tk.tr_quantize_int_ref(xt, sft, bits, b, mode).numpy()
        np.testing.assert_array_equal(got_int.astype(np.float32) * sf, wo)


@pytest.mark.parametrize(
    "shape,bits,g,k,axis,mode",
    [((24, 64), 9, 2, 3, -1, "largest"),
     ((24, 64), 9, 8, 12, -1, "largest"),
     ((24, 64), 4, 16, 14, -1, "largest"),
     ((24, 64), 9, 32, 32, -1, "largest"),
     ((24, 64), 16, 8, 16, -1, "largest"),
     ((24, 64), 9, 8, 12, -1, "serial"),
     ((24, 64), 4, 16, 5, -1, "serial"),
     ((64, 32, 3, 3), 9, 8, 16, 1, "largest"),   # OIHW, grouped on axis 1
     ((3, 50), 8, 16, 20, -1, "largest"),        # 50 % 16 != 0
     ((37, 70), 16, 32, 40, 0, "serial"),        # bits=16, 37 % 32 != 0
     ((784, 40), 4, 16, 6, 0, "largest"),        # dense (in, out), axis 0
     ((5, 9), 6, 1, 2, 1, "largest")])
def test_grouped_matches_jax(rng, shape, bits, g, k, axis, mode):
    x = rng.normal(0, 1, size=shape).astype(np.float32)
    sf = np.float32(np.abs(x).max() / 2 ** (bits - 1))
    want_op = np.asarray(jtr.term_reveal(jnp.asarray(x), sf, bits, g, k,
                                         axis=axis, keep_mode=mode))
    want_kernel = np.asarray(jk.tr_quantize(jnp.asarray(x), sf, bits, g, k,
                                            axis=axis, keep_mode=mode))
    got = tk.tr_quantize_ref(torch.from_numpy(x), torch.tensor(sf), bits, g,
                             k, axis, mode).numpy()
    np.testing.assert_array_equal(got, want_op)
    np.testing.assert_array_equal(got, want_kernel)


@pytest.mark.parametrize("bits,k", [(9, 3), (6, 6), (8, 8), (4, 2), (8, 5),
                                    (16, 16), (12, 2)])
def test_term_reveal_elementwise_matches_jax(rng, bits, k):
    x = rng.normal(0, 1, size=(7, 130)).astype(np.float32)
    sf = np.float32(0.013)
    np.testing.assert_array_equal(
        ttr.term_reveal_elementwise(torch.from_numpy(x), torch.tensor(sf),
                                    bits, k).numpy(),
        np.asarray(jtr.term_reveal_elementwise(jnp.asarray(x), sf, bits, k)))
    np.testing.assert_array_equal(
        ttr.term_reveal_elementwise_int(torch.from_numpy(x), torch.tensor(sf),
                                        bits, k).numpy(),
        np.asarray(jtr.term_reveal_elementwise_int(jnp.asarray(x), sf, bits,
                                                   k)))


def test_uniform_quantize_matches_jax(rng):
    x = (rng.normal(0, 3, size=(1000,)) ).astype(np.float32)
    x[:4] = [0.0, -0.0, 1e30, -1e30]
    sf = np.float32(0.07)
    qj, sj = jtr.uniform_quantize(jnp.asarray(x), sf, 7)
    qt, st = ttr.uniform_quantize(torch.from_numpy(x), torch.tensor(sf), 7)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_cpu_tensor_takes_plain_path_and_counts_no_launch(rng):
    x = torch.from_numpy(rng.normal(size=(16, 48)).astype(np.float32))
    for g in (1, 16):
        got = tk.tr_quantize(x, 0.05, 8, g, 3, axis=-1)
        torch.testing.assert_close(
            got, tk.tr_quantize_ref(x, 0.05, 8, g, 3, axis=-1),
            rtol=0, atol=0)
    torch.testing.assert_close(tk.tr_quantize_int(x, 0.05, 8, 3),
                               tk.tr_quantize_int_ref(x, 0.05, 8, 3),
                               rtol=0, atol=0)
    xb = x.to(torch.bfloat16)
    assert torch.equal(tk.tr_quantize(xb, 0.05, 8, 1, 3),
                       tk.tr_quantize_ref(xb, 0.05, 8, 1, 3))
    assert torch.equal(tk.tr_scale_copy(x, 0.05), x * 0.05)
    assert tk.tr_quantize.launches == {"elementwise": 0,
                                       "elementwise_bf16": 0,
                                       "elementwise_int": 0,
                                       "elementwise_bf16_int": 0,
                                       "grouped": 0}
    assert tk.tr_scale_copy.launches == {"scale_copy": 0}


def test_rejects_bad_arguments(rng):
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="group_size"):
        tk.tr_quantize(x, 0.1, 8, 0, 3)
    with pytest.raises(ValueError, match="keep_mode"):
        tk.tr_quantize(x, 0.1, 8, 1, 3, keep_mode="random")
