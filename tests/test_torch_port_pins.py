"""Direct pins of faults fixed in the port, each on the CPU: the three the
serving export brought to light (a plain version's transposed output, a
scale that is a view of a larger storage, an LSTM's aliased zero (h, c)),
and a reserved checkpoint meta name."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu_torch.kernels.tr_quantize import tr_quantize_ref
from tq_tpu_torch.layers.quantize import mse_search_scale
from tq_tpu_torch.utils import checkpoint as tckpt
from tq_tpu_torch.utils.export import export_serving, load_serving

jtq = importlib.import_module("tq_tpu.kernels.tr_quantize")


@pytest.mark.parametrize("group_size,axis", [(1, 1), (8, 0), (8, 1)])
def test_tr_quantize_ref_of_a_transposed_view_is_contiguous(rng, group_size,
                                                            axis):
    """The plain version returns a contiguous tensor for a transposed
    input, as the kernels do (and as the JAX package's arrays, which carry
    no strides, are), equal to the JAX kernel in interpret mode."""
    x = rng.normal(size=(24, 40)).astype(np.float32)
    xt = torch.from_numpy(x).t()  # (40, 24), a view
    assert not xt.is_contiguous()
    got = tr_quantize_ref(xt, torch.tensor(0.05), 6, group_size, 3, axis)
    assert got.is_contiguous() and got.shape == (40, 24)
    want = jtq.tr_quantize(jnp.asarray(x.T), jnp.float32(0.05), 6,
                           group_size, 3, axis, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mse_search_scale_owns_its_storage(rng):
    """The search's scale is a tensor of its own, not a 0-d view of its
    candidates: ``torch.export.save`` stores a view's whole storage."""
    hist = np.floor(rng.uniform(0, 100, size=8192)).astype(np.float32)
    hist[:4096] = 0  # the default grid's 8192 bins, a ReLU's half empty
    sf = mse_search_scale(torch.from_numpy(hist), 6, 3)
    assert sf.ndim == 0 and sf.dtype == torch.float32
    assert sf.untyped_storage().nbytes() == sf.element_size()


def test_step_exported_with_aliased_zero_state_reads_c(tmp_path):
    """An LSTM's zero (h, c) is one tensor twice; the exported step still
    takes h and c as two inputs, and reads c where the step reads c."""
    zero = torch.zeros(2, 1, 3)

    def step(tok, hidden):
        h, c = hidden
        return tok.to(torch.float32) + h, 2.0 * h + 3.0 * c

    path = tmp_path / "step.pt2"
    export_serving(step, (torch.ones(1, 1, dtype=torch.int64), (zero, zero)),
                   path)
    loaded = load_serving(path)
    h, c = torch.full((2, 1, 3), 1.0), torch.full((2, 1, 3), 10.0)
    out, state = loaded(torch.ones(1, 1, dtype=torch.int64), (h, c))
    torch.testing.assert_close(state, torch.full((2, 1, 3), 32.0))
    torch.testing.assert_close(out, torch.full((2, 1, 3), 2.0))


@pytest.mark.parametrize("meta", [{"store_dtype": "none"},
                                  {"cell": "LSTM", "store_dtype": "float16"}])
def test_save_params_refuses_a_reserved_meta_name(tmp_path, meta):
    """``meta={"store_dtype": ...}`` would overwrite the marker that
    load_params widens floats by; the port refuses it (the JAX package
    lets it through: a difference by design)."""
    tree = {"w": np.ones((2, 2), np.float16)}
    with pytest.raises(ValueError, match="reserved name"):
        tckpt.save_params(tmp_path / "bad.npz", tree, meta=meta)
    assert not (tmp_path / "bad.npz").exists()
    tckpt.save_params(tmp_path / "ok.npz", tree, meta={"cell": "LSTM"})
    back, got = tckpt.load_params(tmp_path / "ok.npz", with_meta=True)
    assert got == {"store_dtype": "none", "cell": "LSTM"}
    assert back["w"].dtype == np.float16
