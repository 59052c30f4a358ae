// wsipack — native host-side graph packing / batching.
//
// The host half of the input pipeline: concatenating per-slide graph arrays
// into one padded, size-bucketed batch (the dgl.batch analog; see
// graph/batch.py for the reference semantics). This is the loader's hot
// path when streaming cohorts of large slides — one multithreaded pass
// writes features, typed edge stores, segment ids and masks directly into
// the caller's pinned output buffers, replacing a chain of numpy
// concatenate/pad allocations.
//
// Plain C ABI for ctypes; no Python.h dependency.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Pack n_graphs slide graphs into padded batch buffers.
// Per-graph inputs are arrays of pointers; outputs must be preallocated to
// the padded capacities. Padding regions are zero-filled, masks written.
// Returns 0 on success, -1 if capacities are too small.
int wsipack_batch(
    int64_t n_graphs,
    const int64_t* n_nodes,           // [n_graphs]
    const int64_t* n_edges,           // [n_graphs]
    const float* const* feats,        // [n_graphs] -> [n_nodes_i * feat_dim]
    const int32_t* const* node_types, // [n_graphs] -> [n_nodes_i]
    const int32_t* const* srcs,       // [n_graphs] -> [n_edges_i]
    const int32_t* const* dsts,
    const int32_t* const* esigns,
    const float* const* sims,
    int64_t feat_dim,
    int64_t cap_nodes,
    int64_t cap_edges,
    float* out_feat,                  // [cap_nodes * feat_dim]
    int32_t* out_ntype,               // [cap_nodes]
    int32_t* out_ngraph,              // [cap_nodes]
    uint8_t* out_nmask,               // [cap_nodes]
    int32_t* out_src,                 // [cap_edges]
    int32_t* out_dst,
    int32_t* out_esign,
    float* out_sim,
    uint8_t* out_emask,
    int32_t n_threads) {
  int64_t total_nodes = 0, total_edges = 0;
  std::vector<int64_t> node_off(n_graphs), edge_off(n_graphs);
  for (int64_t g = 0; g < n_graphs; ++g) {
    node_off[g] = total_nodes;
    edge_off[g] = total_edges;
    total_nodes += n_nodes[g];
    total_edges += n_edges[g];
  }
  if (total_nodes > cap_nodes || total_edges > cap_edges) return -1;

  auto pack_one = [&](int64_t g) {
    const int64_t nn = n_nodes[g], ne = n_edges[g];
    const int64_t no = node_off[g], eo = edge_off[g];
    std::memcpy(out_feat + no * feat_dim, feats[g],
                sizeof(float) * nn * feat_dim);
    std::memcpy(out_ntype + no, node_types[g], sizeof(int32_t) * nn);
    for (int64_t i = 0; i < nn; ++i) out_ngraph[no + i] = (int32_t)g;
    std::memset(out_nmask + no, 1, nn);
    const int32_t off = (int32_t)no;
    for (int64_t e = 0; e < ne; ++e) {
      out_src[eo + e] = srcs[g][e] + off;
      out_dst[eo + e] = dsts[g][e] + off;
    }
    std::memcpy(out_esign + eo, esigns[g], sizeof(int32_t) * ne);
    std::memcpy(out_sim + eo, sims[g], sizeof(float) * ne);
    std::memset(out_emask + eo, 1, ne);
  };

  if (n_threads <= 1 || n_graphs <= 1) {
    for (int64_t g = 0; g < n_graphs; ++g) pack_one(g);
  } else {
    std::atomic<int64_t> next(0);
    const int t = std::min<int64_t>(n_threads, n_graphs);
    std::vector<std::thread> pool;
    pool.reserve(t);
    for (int i = 0; i < t; ++i) {
      pool.emplace_back([&]() {
        int64_t g;
        while ((g = next.fetch_add(1)) < n_graphs) pack_one(g);
      });
    }
    for (auto& th : pool) th.join();
  }

  // zero-fill padding tails (feat tail dominates; do it last, single pass)
  std::memset(out_feat + total_nodes * feat_dim, 0,
              sizeof(float) * (cap_nodes - total_nodes) * feat_dim);
  std::memset(out_ntype + total_nodes, 0,
              sizeof(int32_t) * (cap_nodes - total_nodes));
  std::memset(out_ngraph + total_nodes, 0,
              sizeof(int32_t) * (cap_nodes - total_nodes));
  std::memset(out_nmask + total_nodes, 0, cap_nodes - total_nodes);
  std::memset(out_src + total_edges, 0,
              sizeof(int32_t) * (cap_edges - total_edges));
  std::memset(out_dst + total_edges, 0,
              sizeof(int32_t) * (cap_edges - total_edges));
  std::memset(out_esign + total_edges, 0,
              sizeof(int32_t) * (cap_edges - total_edges));
  std::memset(out_sim + total_edges, 0,
              sizeof(float) * (cap_edges - total_edges));
  std::memset(out_emask + total_edges, 0, cap_edges - total_edges);
  return 0;
}

// Sort an edge store by key (e.g. dst * n_combos + combo) in-place via a
// permutation — preparation for sorted-segment kernels. Counting sort over
// the bounded key space; O(E + K).
int wsipack_sort_edges(
    int64_t n_edges,
    const int64_t* keys,     // [n_edges], values in [0, n_keys)
    int64_t n_keys,
    int64_t* perm_out) {     // [n_edges] permutation: sorted[i] = perm[i]
  std::vector<int64_t> count(n_keys + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    if (keys[e] < 0 || keys[e] >= n_keys) return -1;
    ++count[keys[e] + 1];
  }
  for (int64_t k = 0; k < n_keys; ++k) count[k + 1] += count[k];
  for (int64_t e = 0; e < n_edges; ++e) perm_out[count[keys[e]]++] = e;
  return 0;
}

}  // extern "C"
