"""The port's calibration (histogram, grids, MSE scale search) against the
JAX package on the same inputs."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tq_tpu_torch.kernels import histogram as hist
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


def _edges_and_neighbours(num_bins):
    """Every bin edge of [-50, 50] in ``num_bins`` bins and its float32
    neighbour below."""
    width = np.float32(100 / num_bins)
    edges = np.float32(-50) + np.arange(num_bins + 1, dtype=np.float32) * width
    return np.concatenate([edges, np.nextafter(edges, np.float32(-np.inf))])


def _case_input(rng, case):
    """(the tensor, num_bins): the inputs the histogram kernel has to count
    as the plain version does."""
    if case == "nan_inf_negzero":
        x = (rng.normal(size=4000) * 20).astype(np.float32)
        x[::7] = np.nan
        x[1::11] = np.inf
        x[2::13] = -np.inf
        x[3::5] = -0.0
        return torch.from_numpy(x), 8192
    if case == "zero_run":  # ReLU's zeros: the hot bin
        x = np.maximum(rng.normal(size=(64, 9, 9, 16)), 0).astype(np.float32)
        x.reshape(-1)[1000:40000] = 0.0
        return torch.from_numpy(x), 8192
    if case == "edges":
        return torch.from_numpy(_edges_and_neighbours(8192)), 8192
    if case == "odd_length":  # not a multiple of 4
        return torch.from_numpy((rng.normal(size=4099) * 30)
                                .astype(np.float32)), 8192
    if case == "offset_view":  # one element past the start: off 16 bytes
        base = torch.from_numpy((rng.normal(size=5003) * 30)
                                .astype(np.float32))
        return base[1:4002], 8192
    if case == "strided_view":  # 1-D, every third element
        base = torch.from_numpy((rng.normal(size=9001) * 30)
                                .astype(np.float32))
        return base[::3], 8192
    if case == "small_bins":
        x = np.concatenate([_edges_and_neighbours(1024),
                            (rng.normal(size=3001) * 30).astype(np.float32)])
        return torch.from_numpy(x), 1024
    raise ValueError(case)


@pytest.mark.parametrize("case", ["nan_inf_negzero", "zero_run", "edges",
                                  "odd_length", "offset_view",
                                  "strided_view", "small_bins"])
def test_histogram_update_cases_equal_jax(rng, case):
    """The cases the histogram kernel must count as the plain version does,
    against the JAX package: NaN, +-inf and -0.0 (never or always counted),
    a long run of exact zeros, every bin edge and its neighbour, a length
    off a multiple of 4, a view off 16 bytes, a strided 1-D view, SMALL's
    1,024 bins."""
    x, num_bins = _case_input(rng, case)
    cfg = dict(num_bins=num_bins)
    hj = jq.histogram_update(jq.init_histogram(jq.CalibConfig(**cfg)),
                             jnp.asarray(x.numpy()), jq.CalibConfig(**cfg))
    ht = tq.histogram_update(tq.init_histogram(tq.CalibConfig(**cfg)), x,
                             tq.CalibConfig(**cfg))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    xs = x.numpy()
    assert int(ht.sum()) == int(((xs >= -50) & (xs <= 50)).sum())
    # The plain version's int64 counts are the histogram's.
    assert torch.equal(hist.histogram(x, num_bins, -50.0, 50.0),
                       ht.to(torch.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
def test_histogram_update_cpu_keeps_plain_path(rng, dtype):
    """A CPU tensor of any dtype takes the plain version: the kernel's
    launch count does not move, and the counts are the plain version's."""
    x = torch.from_numpy((rng.normal(size=3000) * 20).astype(np.float32))
    x = x.to(dtype)
    before = dict(hist.histogram.launches)
    h = tq.histogram_update(tq.init_histogram(), x)
    assert hist.histogram.launches == before
    assert torch.equal(h, hist.histogram_ref(x, 8192, -50.0, 50.0)
                       .to(torch.float32))


@pytest.mark.parametrize("num_bins,minv,maxv", [
    (1, -50.0, 50.0), (7, -50.0, 50.0), (1024, -8.0, 8.0),
    (16384, -50.0, 50.0), (20000, -50.0, 50.0), (8192, 0.0, 3.0)])
def test_histogram_update_bins_and_range_equal_jax(rng, num_bins, minv,
                                                   maxv):
    """Counts at other bin counts and ranges equal the JAX package's, and
    ``count_reduce`` receives the batch's int64 counts."""
    x = (rng.normal(size=6001) * (maxv - minv) / 3 + (maxv + minv) / 2
         ).astype(np.float32)
    kw = dict(num_bins=num_bins, minv=minv, maxv=maxv)
    hj = jq.histogram_update(jq.init_histogram(jq.CalibConfig(**kw)),
                             jnp.asarray(x), jq.CalibConfig(**kw))
    seen = []

    def reduce(counts):
        seen.append(counts.dtype)
        return counts

    ht = tq.histogram_update(tq.init_histogram(tq.CalibConfig(**kw)),
                             torch.from_numpy(x), tq.CalibConfig(**kw),
                             count_reduce=reduce)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert seen == [torch.int64]


@pytest.mark.parametrize("n,addr", [(1, 0), (3, 4), (5, 12), (4099, 4),
                                    (4101, 8), (12845056, 0),
                                    (1605632, 8), (10**10 + 3, 12)])
def test_histogram_plan_covers_every_element(n, addr):
    """The launch's head, vectors and tail cover the n elements once, the
    vectors start 16-byte aligned, head and tail stay below one vector, and
    the grid has at least one block and at most two an SM."""
    p = hist.plan(n, addr, 132)
    assert p.head + 4 * p.n_vec + p.tail == n
    assert 0 <= p.head < 4 and 0 <= p.tail < 4
    assert p.n_vec == 0 or (addr + 4 * p.head) % 16 == 0
    assert 1 <= p.blocks <= 2 * 132
    if n >= 2 * 132 * 512 * 4 * 4:
        assert p.blocks == 2 * 132


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
