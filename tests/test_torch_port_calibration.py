"""The port's calibration (histogram, grids, MSE scale search) against the
JAX package on the same inputs."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu_torch.layers import quantize as tq

jq = importlib.import_module("tq_tpu.layers.quantize")

SMALL = dict(num_bins=1024, num_candidates=256)


def _hist_input(rng):
    x = (rng.normal(size=(96, 512)) * 20).astype(np.float32)
    width = np.float32(100 / 8192)
    edges = (np.float32(-50) + np.arange(600, dtype=np.float32) * width)
    flat = x.reshape(-1)
    flat[:600] = edges                                 # exact bin edges
    flat[600:1200] = np.nextafter(edges, np.float32(-np.inf))
    flat[1200:1206] = [-50.0, 50.0, -50.000004, 50.000004, 1e9, -1e9]
    return x


def test_histogram_update_counts_equal(rng):
    x = _hist_input(rng)
    hj = jq.histogram_update(jq.init_histogram(), jnp.asarray(x))
    hj = jq.histogram_update(hj, jnp.asarray(x[:7] * 0.5))
    ht = tq.histogram_update(tq.init_histogram(), torch.from_numpy(x))
    ht = tq.histogram_update(ht, torch.from_numpy(x[:7] * 0.5))
    assert ht.dtype == torch.float32
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    in_range = lambda v: int(((v >= -50) & (v <= 50)).sum())
    assert int(ht.sum()) == in_range(x) + in_range(x[:7] * 0.5) < x.size + 7 * 512


def test_default_grids_equal_jnp_linspace():
    x_grid, sfs = tq.calibration_grids()
    np.testing.assert_array_equal(x_grid.numpy(),
                                  np.asarray(jnp.linspace(-50.0, 50.0, 8192)))
    np.testing.assert_array_equal(sfs.numpy(),
                                  np.asarray(jnp.linspace(1e-8, 50.0, 2048)))
    # torch.linspace rounds differently: the reason the grids are pinned.
    assert not torch.equal(torch.linspace(-50.0, 50.0, 8192), x_grid)


def test_small_config_grids_equal_jnp_linspace():
    cfg = tq.CalibConfig(**SMALL)
    x_grid, sfs = tq.calibration_grids(cfg)
    np.testing.assert_array_equal(
        x_grid.numpy(), np.asarray(jnp.linspace(cfg.minv, cfg.maxv,
                                                cfg.num_bins)))
    np.testing.assert_array_equal(
        sfs.numpy(), np.asarray(jnp.linspace(cfg.sf_min, cfg.maxv,
                                             cfg.num_candidates)))


def _activation_hist(rng, num_bins, scale):
    """A histogram shaped like a ReLU layer's activations."""
    centre = num_bins // 2
    n = np.arange(num_bins)
    h = np.exp(-np.maximum(n - centre, 0) / (scale * num_bins / 100))
    h = np.floor(h * 5000 * rng.uniform(0.5, 1.0, size=num_bins))
    h[:centre] = 0
    h[centre] += 40000  # the ReLU's zeros
    return h.astype(np.float32)


@pytest.mark.parametrize("bits,terms", [(6, 6), (16, 16), (4, 4)])
def test_mse_search_degenerate_budget_default_config(rng, bits, terms):
    h = _activation_hist(rng, 8192, scale=1.0)
    want = float(jq.mse_search_scale(jnp.asarray(h), bits, terms))
    got = tq.mse_search_scale(torch.from_numpy(h), bits, terms)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == want


@pytest.mark.parametrize("bits,terms,scale", [(4, 2, 1.0), (8, 3, 0.5),
                                              (6, 2, 3.0)])
def test_mse_search_non_degenerate_small_config(rng, bits, terms, scale):
    jcfg = jq.CalibConfig(**SMALL)
    tcfg = tq.CalibConfig(**SMALL)
    h = _activation_hist(rng, jcfg.num_bins, scale)
    want = float(jq.mse_search_scale(jnp.asarray(h), bits, terms, jcfg))
    got = float(tq.mse_search_scale(torch.from_numpy(h), bits, terms, tcfg))
    assert got == want


@pytest.mark.parametrize("bits,terms", [(6, 6), (4, 2), (8, 3)])
def test_act_quantize_matches_jax(rng, bits, terms):
    x = np.maximum(rng.normal(size=(33, 70)), 0).astype(np.float32) * 3
    sf = np.float32(0.11)
    np.testing.assert_array_equal(
        tq.act_quantize(torch.from_numpy(x), torch.tensor(sf), bits,
                        terms).numpy(),
        np.asarray(jq.act_quantize(jnp.asarray(x), sf, bits, terms)))
