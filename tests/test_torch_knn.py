"""Port parity: KNN (its exact and approx routes), Pearson and lattice
construction (wsi_hgnn_tpu_torch/ops, kernels/knn.py, models/lattice.py)
against the JAX package on the same numpy inputs, on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wsi_hgnn_tpu.models.lattice import build_lattice_device as jax_build
from wsi_hgnn_tpu.ops import knn as jknn
from wsi_hgnn_tpu.ops import pearson as jpearson
from wsi_hgnn_tpu.ops.pallas_knn import knn_l2_pallas
from wsi_hgnn_tpu_torch.kernels.knn import knn_l2_fused, knn_l2_reference
from wsi_hgnn_tpu_torch.models.lattice import build_lattice_device
from wsi_hgnn_tpu_torch.ops import knn as tknn
from wsi_hgnn_tpu_torch.ops import pearson as tpearson
import port_threads  # noqa: F401  (torch threads per test worker)


def _features(kind, n, d, seed):
    rng = np.random.RandomState(seed)
    f = rng.randn(n, d).astype(np.float32)
    if kind == "exact":
        # multiples of 1/8 with small magnitude: every product and partial
        # sum is exact in f32, so summation order cannot move a distance;
        # duplicated rows then plant exact ties between candidates
        f = np.round(f * 8) / 8
        f[1::5] = f[0:n - 1:5][: len(f[1::5])]
    return f


@pytest.mark.parametrize("kind", ["exact", "gaussian"])
def test_knn_matches_jax_exact_and_pallas(kind):
    """N=384 is not a multiple of 512; a padding mask; k=8. Indices must
    equal both JAX routes exactly (ties to the lower index)."""
    n, k = 384, 8
    f = _features(kind, n, 32, 0)
    mask = np.arange(n) < 300
    i_ref, d_ref = jknn.knn_l2(jnp.asarray(f), k, jnp.asarray(mask))
    i_pal, _ = knn_l2_pallas(jnp.asarray(f), k, jnp.asarray(mask),
                             tile_q=128, tile_c=128, interpret=True)
    i_t, d_t = knn_l2_fused(torch.from_numpy(f), k, torch.from_numpy(mask))
    assert i_t.dtype == torch.int32 and d_t.dtype == torch.float32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_pal))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_ref), rtol=1e-5,
                               atol=1e-4)
    if kind == "exact":
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_ref))


@pytest.mark.parametrize("layout", ["all_rows_equal", "duplicated_block"])
def test_knn_tie_rule_matches_jax_exact_and_pallas(layout):
    """Massive exact ties, the case where the split CUDA kernel's threads
    and splits arrive in any order: every tie must still go to the lower
    candidate index, as both JAX routes decide it, index for index."""
    n, k = 256, 8
    f = _features("exact", n, 16, 6)
    if layout == "all_rows_equal":
        f[:] = f[0]
    else:
        f[40:150] = f[40]    # one block of 110 identical rows
    mask = np.arange(n) < 240
    i_ref, d_ref = jknn.knn_l2(jnp.asarray(f), k, jnp.asarray(mask))
    i_pal, d_pal = knn_l2_pallas(jnp.asarray(f), k, jnp.asarray(mask),
                                 tile_q=128, tile_c=128, interpret=True)
    i_t, d_t = knn_l2_fused(torch.from_numpy(f), k, torch.from_numpy(mask))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_pal))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_pal))
    if layout == "all_rows_equal":
        # the lowest live indices but the query's own
        for q in (0, 5, 100, 250):
            want = [j for j in range(240) if j != q][:k]
            np.testing.assert_array_equal(i_t.numpy()[q], want)
    else:
        # a row of the block: the block's lowest other indices, at 0
        assert (d_t.numpy()[60] == 0).all()
        np.testing.assert_array_equal(i_t.numpy()[60],
                                      [j for j in range(40, 49)][:k])


def test_knn_tiny_slide_selects_self_and_padding_like_jax():
    """Fewer live candidates than k: the remaining slots take the
    f32-max entries in index order, as the exact JAX route does."""
    f = _features("gaussian", 40, 8, 1)
    mask = np.arange(40) < 5
    i_ref, d_ref = jknn.knn_l2(jnp.asarray(f), 8, jnp.asarray(mask))
    i_t, d_t = knn_l2_reference(torch.from_numpy(f), 8,
                                torch.from_numpy(mask))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_ref), rtol=1e-5)
    assert (d_t.numpy()[:5, 4:] == np.finfo(np.float32).max).all()


def test_knn_tiled_and_dispatch():
    f = _features("gaussian", 600, 16, 2)
    mask = torch.from_numpy(np.arange(600) < 550)
    ft = torch.from_numpy(f)
    i_d, d_d = tknn.knn_l2(ft, 6, mask)
    i_s, d_s = tknn.knn_l2_tiled(ft, 6, mask, tile=256)
    np.testing.assert_array_equal(i_s.numpy(), i_d.numpy())
    np.testing.assert_allclose(d_s.numpy(), d_d.numpy(), rtol=1e-6)
    i_j, _ = jknn.knn_l2_tiled(jnp.asarray(f), 6, jnp.asarray(mask.numpy()),
                               tile=256)
    np.testing.assert_array_equal(i_s.numpy(), np.asarray(i_j))
    for impl in ("exact", "pallas", "approx"):
        i_l, d_l = tknn.knn_lookup(ft, 6, mask, impl=impl)
        np.testing.assert_array_equal(i_l.numpy(), i_d.numpy())
        np.testing.assert_array_equal(d_l.numpy(), d_d.numpy())
    with pytest.raises(ValueError, match="unknown knn impl"):
        tknn.knn_lookup(ft, 6, mask, impl="hnsw")


def test_knn_lookup_streams_past_threshold():
    big = _features("gaussian", tknn.STREAM_THRESHOLD, 4, 3)
    ft = torch.from_numpy(big)
    i_l, _ = tknn.knn_lookup(ft, 4)
    i_s, _ = tknn.knn_l2_tiled(ft, 4)
    np.testing.assert_array_equal(i_l.numpy(), i_s.numpy())


def test_pearson_matches_jax():
    rng = np.random.RandomState(4)
    f = rng.randn(50, 64).astype(np.float32)
    src, dst = rng.randint(0, 50, 80), rng.randint(0, 50, 80)
    idx = rng.randint(0, 50, (50, 8)).astype(np.int32)
    ft = torch.from_numpy(f)
    np.testing.assert_allclose(
        tpearson.center_normalize(ft).numpy(),
        np.asarray(jpearson.center_normalize(jnp.asarray(f))), atol=1e-5)
    np.testing.assert_allclose(
        tpearson.pearson_sim_at(ft, torch.from_numpy(idx), tile=16).numpy(),
        np.asarray(jpearson.pearson_sim_at(jnp.asarray(f), jnp.asarray(idx),
                                           tile=16)), atol=1e-5)
    es_t, sim_t = tpearson.pearson_edges(ft, torch.from_numpy(src),
                                         torch.from_numpy(dst))
    es_j, sim_j = jpearson.pearson_edges(jnp.asarray(f), jnp.asarray(src),
                                         jnp.asarray(dst))
    np.testing.assert_allclose(sim_t.numpy(), np.asarray(sim_j), atol=1e-5)
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j))


@pytest.mark.parametrize("n_real", [[64, 54], [64, 3]])
def test_lattice_build_matches_jax(n_real):
    """[B, N, k] lattice: neighbours, Pearson sims, signs and edge masks,
    including a slide smaller than k (self-edges dropped)."""
    b, n, d, radius = 2, 64, 16, 5
    rng = np.random.RandomState(5)
    feats = rng.randn(b, n, d).astype(np.float32)
    ntypes = rng.randint(0, 6, (b, n)).astype(np.int32)
    mask = np.arange(n)[None, :] < np.array(n_real)[:, None]
    g_j = jax_build(jnp.asarray(feats), jnp.asarray(ntypes),
                    jnp.asarray(mask), radius, 6)
    g_t = build_lattice_device(torch.from_numpy(feats),
                               torch.from_numpy(ntypes),
                               torch.from_numpy(mask), radius, 6)
    np.testing.assert_array_equal(g_t.idx.numpy(), np.asarray(g_j.idx))
    np.testing.assert_allclose(g_t.sim.numpy(), np.asarray(g_j.sim),
                               atol=1e-5)
    np.testing.assert_array_equal(g_t.esign.numpy(), np.asarray(g_j.esign))
    np.testing.assert_array_equal(g_t.emask.numpy(), np.asarray(g_j.emask))


@pytest.mark.parametrize("n, d", [(600, 16), (4096, 32)])
def test_approx_matches_jax_approx_on_untied_data(n, d):
    """Gaussian features with a padded tail, below and at STREAM_THRESHOLD
    (the streaming route in both packages): the port's approx gives JAX's
    approx indices exactly and its distances to rtol 1e-6, through
    knn_lookup (and, below the threshold, through the approx keyword of
    knn_l2 and knn_l2_tiled)."""
    k = 8
    f = _features("gaussian", n, d, 20)
    mask = np.arange(n) < n - n // 16
    fj, mj = jnp.asarray(f), jnp.asarray(mask)
    ft, mt = torch.from_numpy(f), torch.from_numpy(mask)
    i_j, d_j = jknn.knn_lookup(fj, k, mj, impl="approx")
    i_t, d_t = tknn.knn_lookup(ft, k, mt, impl="approx")
    assert i_t.dtype == torch.int32 and d_t.dtype == torch.float32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6)
    # the recall the JAX package's own approx test asks of the route
    live = np.asarray(i_j)[mask]
    recall = np.mean([len(set(a) & set(b)) / k
                      for a, b in zip(i_t.numpy()[mask], live)])
    assert recall >= 0.95
    if n < tknn.STREAM_THRESHOLD:
        np.testing.assert_array_equal(
            tknn.knn_l2(ft, k, mt, approx=True)[0].numpy(),
            np.asarray(jknn.knn_l2(fj, k, mj, approx=True)[0]))
        np.testing.assert_array_equal(
            tknn.knn_l2_tiled(ft, k, mt, tile=256, approx=True)[0].numpy(),
            np.asarray(jknn.knn_l2_tiled(fj, k, mj, tile=256,
                                         approx=True)[0]))


def _true_d2(f, mask):
    """float64 squared distances (exact for these small-integer or
    1/8-grid features), self and masked candidates at f32 max."""
    f64 = f.astype(np.float64)
    d2 = ((f64[:, None, :] - f64[None, :, :]) ** 2).sum(-1)
    big = float(np.finfo(np.float32).max)
    d2[np.arange(len(f)), np.arange(len(f))] = big
    d2[:, ~mask] = big
    return d2


def _assert_valid_knn(idx, d2, true_d2, k):
    """idx/d2 [N, k] is a k-nearest set of every row: distances ascending
    and equal to the row's k smallest, every index strictly inside the
    k-th distance present (as a set), the ones at the k-th distance
    distinct members of that tie group."""
    for i in range(len(idx)):
        row = true_d2[i]
        np.testing.assert_array_equal(d2[i], np.sort(row)[:k].astype(np.float32))
        kth = row[idx[i, -1]]
        assert len(set(idx[i])) == k
        np.testing.assert_array_equal(row[idx[i]], np.sort(row)[:k])
        assert set(idx[i][row[idx[i]] < kth]) == set(np.flatnonzero(row < kth))
        assert (row[idx[i][row[idx[i]] == kth]] == kth).all()


@pytest.mark.parametrize("kind", ["planted_duplicates", "three_levels"])
def test_approx_under_ties_is_a_valid_knn_set_like_jax(kind):
    """approx promises no order among equal distances (the JAX package's
    own test: "approx_min_k may reorder ties"), so under ties the port's
    indices need not equal JAX's: both must be valid k-NN sets with equal
    distances, equal as sets strictly inside the k-th distance. On planted
    duplicate rows the port also holds recall >= 0.95 against JAX's set.
    On features in {0,1,2}^4 nearly every row's k-th distance is a large
    tie group, where set recall measures only the tie order the two
    routes pick: there both are checked as valid sets."""
    k = 8
    if kind == "planted_duplicates":
        n, live = 600, 560
        f = _features("exact", n, 16, 21)
    else:
        n, live = 300, 280
        f = np.random.RandomState(22).randint(0, 3, (n, 4)).astype(np.float32)
    mask = np.arange(n) < live
    i_j, d_j = jknn.knn_lookup(jnp.asarray(f), k, jnp.asarray(mask),
                               impl="approx")
    i_j, d_j = np.asarray(i_j), np.asarray(d_j)
    i_t, d_t = tknn.knn_lookup(torch.from_numpy(f), k,
                               torch.from_numpy(mask), impl="approx")
    i_t, d_t = i_t.numpy(), d_t.numpy()
    np.testing.assert_array_equal(d_t, d_j)
    true_d2 = _true_d2(f, mask)
    _assert_valid_knn(i_t, d_t, true_d2, k)
    _assert_valid_knn(i_j, d_j, true_d2, k)
    # and the port keeps its lower-index tie rule: the exact route's lists
    np.testing.assert_array_equal(
        i_t, tknn.knn_lookup(torch.from_numpy(f), k, torch.from_numpy(mask),
                             impl="exact")[0].numpy())
    if kind == "planted_duplicates":
        recall = np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(i_t[mask], i_j[mask])])
        assert recall >= 0.95
