// meshtool: native mesh preprocessing for difffe_tpu.
//
// Host-side, latency-sensitive graph work that sits poorly in XLA:
//   * CSR node adjacency from element connectivity
//   * reverse Cuthill-McKee ordering (bandwidth reduction for banded/block
//     solvers and locality of the gather/scatter assembly)
//   * boundary extraction (edges incident to exactly one 2D element)
//   * triangle quality statistics
//
// The reference has no native code at all (SURVEY.md §2: pure Python);
// this is the runtime-side native (host) layer.  Exposed to
// Python via ctypes (meshtool.py) with a pure-numpy fallback.
//
// Build: ./build.sh  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <vector>

extern "C" {

// Build CSR adjacency from (n_elements x n_per_elem) connectivity.
// Returns total number of directed adjacency entries written, or -1 if the
// provided capacity is insufficient.  Call first with capacity 0 to size.
int64_t build_adjacency(const int32_t* elements, int64_t n_elements,
                        int32_t n_per_elem, int64_t n_nodes,
                        int64_t* row_ptr /* n_nodes+1 */,
                        int32_t* col_idx /* capacity */,
                        int64_t capacity) {
  std::vector<std::vector<int32_t>> adj(n_nodes);
  for (int64_t e = 0; e < n_elements; ++e) {
    const int32_t* el = elements + e * n_per_elem;
    for (int32_t a = 0; a < n_per_elem; ++a) {
      for (int32_t b = 0; b < n_per_elem; ++b) {
        if (a == b) continue;
        adj[el[a]].push_back(el[b]);
      }
    }
  }
  int64_t total = 0;
  for (int64_t v = 0; v < n_nodes; ++v) {
    auto& nb = adj[v];
    std::sort(nb.begin(), nb.end());
    nb.erase(std::unique(nb.begin(), nb.end()), nb.end());
    total += static_cast<int64_t>(nb.size());
  }
  if (capacity < total) {
    if (row_ptr) {
      row_ptr[0] = 0;
      for (int64_t v = 0; v < n_nodes; ++v)
        row_ptr[v + 1] = row_ptr[v] + static_cast<int64_t>(adj[v].size());
    }
    return capacity == 0 ? total : -1;
  }
  row_ptr[0] = 0;
  for (int64_t v = 0; v < n_nodes; ++v) {
    row_ptr[v + 1] = row_ptr[v] + static_cast<int64_t>(adj[v].size());
    std::memcpy(col_idx + row_ptr[v], adj[v].data(),
                adj[v].size() * sizeof(int32_t));
  }
  return total;
}

// Reverse Cuthill-McKee ordering over a CSR graph.
// perm[i] = old index of the node placed at new position i.
void rcm_order(const int64_t* row_ptr, const int32_t* col_idx,
               int64_t n_nodes, int32_t* perm) {
  std::vector<int32_t> degree(n_nodes);
  for (int64_t v = 0; v < n_nodes; ++v)
    degree[v] = static_cast<int32_t>(row_ptr[v + 1] - row_ptr[v]);

  std::vector<char> visited(n_nodes, 0);
  std::vector<int32_t> order;
  order.reserve(n_nodes);

  for (;;) {
    // next unvisited node of minimum degree (new component seed)
    int64_t start = -1;
    for (int64_t v = 0; v < n_nodes; ++v) {
      if (!visited[v] && (start < 0 || degree[v] < degree[start])) start = v;
    }
    if (start < 0) break;

    std::queue<int32_t> q;
    q.push(static_cast<int32_t>(start));
    visited[start] = 1;
    std::vector<int32_t> nbrs;
    while (!q.empty()) {
      int32_t v = q.front();
      q.pop();
      order.push_back(v);
      nbrs.clear();
      for (int64_t i = row_ptr[v]; i < row_ptr[v + 1]; ++i) {
        int32_t w = col_idx[i];
        if (!visited[w]) {
          visited[w] = 1;
          nbrs.push_back(w);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int32_t a, int32_t b) { return degree[a] < degree[b]; });
      for (int32_t w : nbrs) q.push(w);
    }
  }
  // reverse for RCM
  for (int64_t i = 0; i < n_nodes; ++i)
    perm[i] = order[n_nodes - 1 - i];
}

// Bandwidth of a CSR graph under an optional permutation (inv_perm maps
// old index -> new position; pass nullptr for identity).
int64_t graph_bandwidth(const int64_t* row_ptr, const int32_t* col_idx,
                        int64_t n_nodes, const int32_t* inv_perm) {
  int64_t bw = 0;
  for (int64_t v = 0; v < n_nodes; ++v) {
    int64_t pv = inv_perm ? inv_perm[v] : v;
    for (int64_t i = row_ptr[v]; i < row_ptr[v + 1]; ++i) {
      int64_t pw = inv_perm ? inv_perm[col_idx[i]] : col_idx[i];
      bw = std::max(bw, static_cast<int64_t>(std::llabs(pv - pw)));
    }
  }
  return bw;
}

// Mark nodes lying on boundary edges of a triangle mesh (edges that appear
// in exactly one element).  out_mask: n_nodes bytes (1 = boundary).
void boundary_nodes_tri(const int32_t* elements, int64_t n_elements,
                        int64_t n_nodes, uint8_t* out_mask) {
  struct Edge {
    int32_t a, b;
    bool operator<(const Edge& o) const {
      return a != o.a ? a < o.a : b < o.b;
    }
    bool operator==(const Edge& o) const { return a == o.a && b == o.b; }
  };
  std::vector<Edge> edges;
  edges.reserve(n_elements * 3);
  for (int64_t e = 0; e < n_elements; ++e) {
    const int32_t* el = elements + e * 3;
    const int32_t pairs[3][2] = {{el[0], el[1]}, {el[1], el[2]}, {el[2], el[0]}};
    for (auto& p : pairs) {
      Edge ed{std::min(p[0], p[1]), std::max(p[0], p[1])};
      edges.push_back(ed);
    }
  }
  std::sort(edges.begin(), edges.end());
  std::memset(out_mask, 0, n_nodes);
  for (size_t i = 0; i < edges.size();) {
    size_t j = i + 1;
    while (j < edges.size() && edges[j] == edges[i]) ++j;
    if (j - i == 1) {  // boundary edge
      out_mask[edges[i].a] = 1;
      out_mask[edges[i].b] = 1;
    }
    i = j;
  }
}

// Triangle quality: writes per-element [area, min_angle_rad, aspect_ratio].
void tri_quality(const double* nodes /* n_nodes x 2 */,
                 const int32_t* elements, int64_t n_elements,
                 double* out /* n_elements x 3 */) {
  for (int64_t e = 0; e < n_elements; ++e) {
    const int32_t* el = elements + e * 3;
    const double* p0 = nodes + 2 * el[0];
    const double* p1 = nodes + 2 * el[1];
    const double* p2 = nodes + 2 * el[2];
    const double ax = p1[0] - p0[0], ay = p1[1] - p0[1];
    const double bx = p2[0] - p1[0], by = p2[1] - p1[1];
    const double cx = p0[0] - p2[0], cy = p0[1] - p2[1];
    const double la = std::hypot(ax, ay), lb = std::hypot(bx, by),
                 lc = std::hypot(cx, cy);
    const double area = 0.5 * std::fabs(ax * (-cy) - ay * (-cx));
    double lmax = std::max({la, lb, lc}), lmin = std::min({la, lb, lc});
    // angles via law of cosines
    auto angle = [](double opp, double s1, double s2) {
      double c = (s1 * s1 + s2 * s2 - opp * opp) / (2.0 * s1 * s2);
      c = std::max(-1.0, std::min(1.0, c));
      return std::acos(c);
    };
    double a0 = angle(lb, la, lc), a1 = angle(lc, la, lb), a2 = angle(la, lb, lc);
    out[3 * e + 0] = area;
    out[3 * e + 1] = std::min({a0, a1, a2});
    out[3 * e + 2] = (lmin > 0) ? lmax / lmin : INFINITY;
  }
}

}  // extern "C"
