// The sampled tier's host sampler: one call samples a whole batch (the
// layer-wise fanout draws, the relabel to batch-local ids, a self-loop on
// every node, the stable sort by destination and the GCN weights).
//
// The port's copy of the JAX package's C++ full-batch sampler. Its
// arithmetic and draw order are the same, so one seed gives the same batch
// bit for bit:
//
//   - the generator is xorshift128+ with the state {seed ^ golden, seed | 1};
//   - each hop's fanout is clamped at 64; a node of degree at most the
//     fanout takes all its in-edges in CSR order, a larger one draws
//     `fanout` distinct offsets by Floyd's method, one draw each;
//   - nodes get local ids in the order they are first met (seeds first)
//     through an open-addressing map;
//   - the weights are f32, 1/sqrt(in-degree) at both ends.
//
// Unlike the JAX sampler it writes no padding and no node mask: the caller
// reads the real node and edge counts and takes the arrays at that size.
// It still reports truncation (a node or edge cap reached), which the
// caller sizes its caps never to reach and refuses if it happens.
//
// A plain C interface for ctypes, which releases the GIL for the call:
// batches sample concurrently in Python threads.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline uint64_t xorshift(uint64_t* s) {
  uint64_t x = s[0];
  uint64_t const y = s[1];
  s[0] = y;
  x ^= x << 23;
  s[1] = x ^ y ^ (x >> 17) ^ (y >> 26);
  return s[1] + y;
}

// global -> local node ids, open addressing over a power-of-two table
struct NodeMap {
  std::vector<int64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;
  explicit NodeMap(int64_t cap) {
    uint64_t size = 16;
    while (size < (uint64_t)cap * 2) size <<= 1;
    keys.assign(size, -1);
    vals.assign(size, -1);
    mask = size - 1;
  }
  // the local id of g; if absent, g gets insert_id (or -1 is returned when
  // insert_id < 0)
  int32_t lookup_or_insert(int64_t g, int32_t insert_id) {
    uint64_t h = ((uint64_t)g * 0x9e3779b97f4a7c15ULL) & mask;
    while (true) {
      if (keys[h] == g) return vals[h];
      if (keys[h] == -1) {
        if (insert_id < 0) return -1;
        keys[h] = g;
        vals[h] = insert_id;
        return insert_id;
      }
      h = (h + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// Samples the batch of `seeds` over the in-neighbour CSR (indptr, indices).
// Writes the batch's global node ids (seeds first) to node_ids[0, n) and its
// dst-sorted local edges and their weights to out_*[0, e); returns n, stores
// e in n_edges[0]. node_ids holds node_cap entries, out_* edge_cap;
// truncated[0] / [1] are set when a sampled node / an edge did not fit.
int64_t sample_batch(const int64_t* indptr, const int64_t* indices,
                     const int64_t* seeds, int64_t n_seeds,
                     const int64_t* fanouts, int64_t n_hops,
                     int64_t node_cap, int64_t edge_cap, uint64_t seed,
                     int64_t* node_ids, int32_t* out_src, int32_t* out_dst,
                     float* out_w, int64_t* n_edges, int64_t* truncated) {
  uint64_t s[2] = {seed ^ 0x9e3779b97f4a7c15ULL, seed | 1};
  NodeMap map(node_cap);
  std::vector<int64_t> nodes;
  nodes.reserve(node_cap);
  truncated[0] = truncated[1] = 0;

  for (int64_t i = 0; i < n_seeds && (int64_t)nodes.size() < node_cap; ++i) {
    if (map.lookup_or_insert(seeds[i], (int32_t)nodes.size()) ==
        (int32_t)nodes.size())
      nodes.push_back(seeds[i]);
  }

  std::vector<int32_t> e_src, e_dst;
  e_src.reserve(edge_cap);
  e_dst.reserve(edge_cap);
  int64_t picks[64];  // fanout <= 64

  int64_t f_lo = 0, f_hi = (int64_t)nodes.size();
  for (int64_t hop = 0; hop < n_hops && f_lo < f_hi; ++hop) {
    int64_t fanout = fanouts[hop];
    if (fanout > 64) fanout = 64;
    for (int64_t d = f_lo; d < f_hi; ++d) {
      int64_t g = nodes[d];
      int64_t lo = indptr[g], deg = indptr[g + 1] - lo;
      int64_t k = deg < fanout ? deg : fanout;
      if (k <= 0) continue;
      if (deg <= fanout) {
        for (int64_t j = 0; j < k; ++j) picks[j] = lo + j;
      } else {
        // Floyd's distinct sampling of k offsets from [0, deg)
        for (int64_t j = 0; j < k; ++j) {
          int64_t r = (int64_t)(xorshift(s) % (uint64_t)(deg - k + j + 1));
          bool dup = false;
          for (int64_t t = 0; t < j; ++t)
            if (picks[t] == lo + r) { dup = true; break; }
          picks[j] = lo + (dup ? deg - k + j : r);
        }
      }
      for (int64_t j = 0; j < k; ++j) {
        int64_t sg = indices[picks[j]];
        int32_t sl = map.lookup_or_insert(
            sg, (int64_t)nodes.size() < node_cap ? (int32_t)nodes.size()
                                                 : -1);
        if (sl < 0) {  // the node cap is reached: the edge is dropped
          truncated[0] = 1;
          continue;
        }
        if (sl == (int32_t)nodes.size()) nodes.push_back(sg);
        e_src.push_back(sl);
        e_dst.push_back((int32_t)d);
      }
    }
    f_lo = f_hi;
    f_hi = (int64_t)nodes.size();
  }

  int64_t n_real = (int64_t)nodes.size();
  // a self-loop on every node (the reference adds them to the whole graph)
  for (int32_t v = 0; v < (int32_t)n_real; ++v) {
    e_src.push_back(v);
    e_dst.push_back(v);
  }
  int64_t e = (int64_t)e_src.size();
  if (e > edge_cap) {
    truncated[1] = 1;
    e = edge_cap;
  }

  // stable counting sort by destination, and the in-degrees for the weights
  std::vector<int64_t> cnt(n_real + 1, 0);
  for (int64_t i = 0; i < e; ++i) cnt[e_dst[i] + 1]++;
  std::vector<float> dinv(n_real);
  for (int64_t v = 0; v < n_real; ++v) {
    int64_t deg = cnt[v + 1];
    dinv[v] = deg > 0 ? 1.0f / std::sqrt((float)deg) : 0.0f;
  }
  for (int64_t v = 0; v < n_real; ++v) cnt[v + 1] += cnt[v];
  for (int64_t i = 0; i < e; ++i) {
    int64_t pos = cnt[e_dst[i]]++;
    out_src[pos] = e_src[i];
    out_dst[pos] = e_dst[i];
    out_w[pos] = dinv[e_dst[i]] * dinv[e_src[i]];
  }
  for (int64_t i = 0; i < n_real; ++i) node_ids[i] = nodes[i];
  n_edges[0] = e;
  return n_real;
}

}  // extern "C"
