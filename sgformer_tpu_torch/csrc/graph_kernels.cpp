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
//
// The file also holds the hop sampler (the port's copy of the JAX package's
// sample_neighbors: one hop over a frontier, the draws of the sampler's
// use_native=False path) and the clustering reorder's two steps (the port's copies
// of the JAX package's C++ lpa_cluster and cluster_pack, same arithmetic,
// same draw order): label propagation, whose sweep is deterministic and
// independent of the thread count, so one seed gives the same labels; and
// the boundary-aware best-fit-decreasing packing of the clusters into
// contiguous blocks of node ids.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <thread>
#include <tuple>
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

// ---------------------------------------------------------------------------
// The hop sampler: one hop of fanout sampling over a frontier, the port's
// copy of the JAX package's sample_neighbors (same generator and state, same
// draw order). A node of degree at most `fanout` takes all its in-edges in
// CSR order; a larger one draws `fanout` offsets with replacement, one draw
// each (the caller deduplicates). out_src/out_dst hold frontier_len * fanout
// entries; returns the number of edges written.
// ---------------------------------------------------------------------------

int64_t sample_neighbors(const int64_t* indptr, const int64_t* indices,
                         const int64_t* frontier, int64_t frontier_len,
                         int64_t fanout, uint64_t seed, int64_t* out_src,
                         int64_t* out_dst) {
  uint64_t s[2] = {seed ^ 0x9e3779b97f4a7c15ULL, seed | 1};
  int64_t n = 0;
  for (int64_t i = 0; i < frontier_len; ++i) {
    int64_t v = frontier[i];
    int64_t lo = indptr[v], hi = indptr[v + 1];
    int64_t deg = hi - lo;
    if (deg <= 0) continue;
    if (deg <= fanout) {
      for (int64_t e = lo; e < hi; ++e) {
        out_src[n] = indices[e];
        out_dst[n] = v;
        ++n;
      }
    } else {
      for (int64_t k = 0; k < fanout; ++k) {
        int64_t off = (int64_t)(xorshift(s) % (uint64_t)deg);
        out_src[n] = indices[lo + off];
        out_dst[n] = v;
        ++n;
      }
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// Label-propagation clustering. Synchronous sweeps: each node adopts the most
// frequent label among its in-neighbours (all neighbours: the edge list is
// undirected), ties broken by count + U[0, 0.5) drawn from a splitmix64 hash
// of (seed, sweep, node, label); a label holding max_size or more nodes
// stops attracting new members. The loop stops when a sweep changes no
// label, or, past sweep MIN_STOP = 40 and checked every CHECK = 8 sweeps,
// when the same-label fraction of a ~2M-edge stride sample gained less than
// MIN_GAIN = 0.3 points over the last CHECK sweeps. Threads split the nodes;
// the draws depend on (sweep, node) only, so the labels do not depend on the
// thread count. Writes the labels; returns the sweeps run.
// ---------------------------------------------------------------------------

static inline uint64_t lpa_mix(uint64_t z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

int64_t lpa_cluster(const int64_t* src, const int64_t* dst, int64_t n_edges,
                    int64_t n_nodes, int64_t iters, int64_t max_size,
                    uint64_t seed, int64_t* labels_out) {
  if (n_nodes <= 0) return 0;
  // dst-CSR of the in-neighbours, int32 inside (the sweep is a random gather
  // over labels[indices[e]]: half the bytes of int64)
  std::vector<int64_t> indptr(n_nodes + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) indptr[dst[e] + 1]++;
  for (int64_t i = 0; i < n_nodes; ++i) indptr[i + 1] += indptr[i];
  std::vector<int32_t> indices(n_edges);
  {
    std::vector<int64_t> pos(indptr.begin(), indptr.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e)
      indices[pos[dst[e]]++] = (int32_t)src[e];
  }

  std::vector<int32_t> labels(n_nodes), next(n_nodes);
  std::vector<int64_t> sizes(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) labels[i] = (int32_t)i;

  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? (int64_t)hw : 4;
  if (n_threads > n_nodes) n_threads = n_nodes > 0 ? n_nodes : 1;

  const int64_t CHECK = 8;
  const int64_t MIN_STOP = 40;
  const double MIN_GAIN = 0.003;
  int64_t stride = n_edges > 2000000 ? n_edges / 2000000 : 1;
  double prev_frac = -1.0;
  int64_t sweep = 0;
  for (; sweep < iters; ++sweep) {
    std::fill(sizes.begin(), sizes.end(), 0);
    for (int64_t i = 0; i < n_nodes; ++i) sizes[labels[i]]++;

    std::atomic<int64_t> changed(0);
    auto work = [&](int64_t lo, int64_t hi) {
      std::vector<int32_t> nb;
      int64_t local_changed = 0;
      for (int64_t d = lo; d < hi; ++d) {
        int64_t e0 = indptr[d], e1 = indptr[d + 1];
        next[d] = labels[d];
        if (e1 == e0) continue;
        nb.resize(e1 - e0);
        for (int64_t e = e0; e < e1; ++e) nb[e - e0] = labels[indices[e]];
        std::sort(nb.begin(), nb.end());
        double best_key = 0.0;
        int32_t best_label = labels[d];
        bool found = false;
        for (size_t a = 0; a < nb.size();) {
          size_t b = a;
          while (b < nb.size() && nb[b] == nb[a]) ++b;
          int32_t gl = nb[a];
          int64_t count = (int64_t)(b - a);
          // full labels stop attracting new members
          if (!(sizes[gl] >= max_size && gl != labels[d])) {
            uint64_t h = lpa_mix(seed ^ lpa_mix((uint64_t)sweep * 0x51ul ^
                                                (uint64_t)d) ^
                                 (uint64_t)gl * 0x2545f4914f6cdd1dull);
            double key = (double)count +
                         0.5 * ((double)(h >> 11) * 0x1.0p-53);
            if (!found || key > best_key) {
              best_key = key;
              best_label = gl;
              found = true;
            }
          }
          a = b;
        }
        if (found && best_label != labels[d]) {
          next[d] = best_label;
          local_changed++;
        }
      }
      changed.fetch_add(local_changed, std::memory_order_relaxed);
    };
    if (n_threads <= 1) {
      work(0, n_nodes);
    } else {
      std::vector<std::thread> ts;
      int64_t per = (n_nodes + n_threads - 1) / n_threads;
      for (int64_t t = 0; t < n_threads; ++t) {
        int64_t lo = t * per, hi = std::min(n_nodes, lo + per);
        if (lo < hi) ts.emplace_back(work, lo, hi);
      }
      for (auto& t : ts) t.join();
    }
    labels.swap(next);
    if (changed.load() == 0) {
      ++sweep;
      break;
    }
    if ((sweep + 1) % CHECK == 0 && sweep + 1 >= MIN_STOP - CHECK) {
      int64_t same = 0, tot = 0;
      for (int64_t e = 0; e < n_edges; e += stride) {
        tot++;
        same += labels[src[e]] == labels[dst[e]];
      }
      double frac = tot ? (double)same / (double)tot : 0.0;
      if (sweep + 1 >= MIN_STOP && frac < prev_frac + MIN_GAIN) {
        ++sweep;
        break;
      }
      prev_frac = frac;
    }
  }
  for (int64_t i = 0; i < n_nodes; ++i) labels_out[i] = labels[i];
  return sweep;
}

// ---------------------------------------------------------------------------
// Boundary-aware best-fit-decreasing packing of clusters (compacted labels
// 0..C-1) into consecutive blocks of slab_rows new ids: each block takes the
// largest remaining clusters that fit its gap; when none fits, the largest
// pending cluster is split exactly at the boundary (its two pieces stay
// contiguous). A max-heap ordered by (size desc, cluster asc, offset asc).
// Writes perm with perm[new] = old.
// ---------------------------------------------------------------------------

void cluster_pack(const int64_t* clusters, int64_t n_nodes,
                  int64_t slab_rows, int64_t* perm_out) {
  if (n_nodes <= 0) return;
  int64_t n_clusters = 0;
  for (int64_t i = 0; i < n_nodes; ++i)
    n_clusters = std::max(n_clusters, clusters[i] + 1);
  std::vector<int64_t> sizes(n_clusters, 0);
  for (int64_t i = 0; i < n_nodes; ++i) sizes[clusters[i]]++;
  std::vector<int64_t> starts(n_clusters + 1, 0);
  for (int64_t c = 0; c < n_clusters; ++c) starts[c + 1] = starts[c] + sizes[c];
  // stable counting sort of node ids by cluster
  std::vector<int64_t> order(n_nodes);
  {
    std::vector<int64_t> pos(starts.begin(), starts.end() - 1);
    for (int64_t i = 0; i < n_nodes; ++i) order[pos[clusters[i]]++] = i;
  }
  // entries (-size, cluster, offset): a min-heap pops size desc, then
  // cluster asc, then offset asc
  using Ent = std::tuple<int64_t, int64_t, int64_t>;
  std::priority_queue<Ent, std::vector<Ent>, std::greater<Ent>> heap;
  for (int64_t c = 0; c < n_clusters; ++c)
    if (sizes[c] > 0) heap.emplace(-sizes[c], c, 0);
  std::vector<Ent> pending;  // (size, cluster, offset), in pop order
  int64_t out = 0;
  int64_t remaining = slab_rows;
  while (!heap.empty() || !pending.empty()) {
    while (!heap.empty()) {
      auto [neg, c, off] = heap.top();
      heap.pop();
      int64_t size = -neg;
      if (size <= remaining) {
        std::memcpy(perm_out + out, order.data() + starts[c] + off,
                    sizeof(int64_t) * size);
        out += size;
        remaining -= size;
        if (remaining == 0) break;
      } else {
        pending.emplace_back(size, c, off);
      }
    }
    if (remaining > 0 && !pending.empty()) {
      auto [size, c, off] = pending.front();
      pending.erase(pending.begin());
      std::memcpy(perm_out + out, order.data() + starts[c] + off,
                  sizeof(int64_t) * remaining);
      out += remaining;
      pending.emplace_back(size - remaining, c, off + remaining);
      remaining = 0;
    }
    for (auto& [size, c, off] : pending) heap.emplace(-size, c, off);
    pending.clear();
    remaining = slab_rows;
  }
}

}  // extern "C"
