// The alignment methods' sequential host kernels: the mPDP fill of DP and
// the temporal network of TN. Plain C++ for the CPU, built with g++ at
// first use into a shared library with a C interface (kernels/build.py,
// `host_library`) and called through ctypes from align/vta.py.
//
// A copy of the DP and TN parts of vsc22_tpu/native/vta_kernels.cpp; it
// matches align/vta.py's `dp_matrix_reference` and `tn_reference` bit for
// bit.
//
// DP role parity (reference, for cross-checking — original implementation):
//   D1/infer/vcsl/vta.py:174-207 (`njit_dp_matrix`) — the mPDP dynamic
//   program fill, inherently sequential in both axes (left + top
//   dependencies with a conditional freeze), so it runs on the host.

#include <cstdint>
#include <cstring>

extern "C" {

// mPDP fill. sim: [m, n] row-major (already shifted non-negative by caller).
// Outputs: dp [m, n] f64, accu [m, n] i32, back [m, n] i8 (init by callee).
void vta_dp_fill(const double* sim, int64_t m, int64_t n, int64_t discontinue,
                 double min_sim, double* dp, int32_t* accu, int8_t* back) {
  for (int64_t idx = 0; idx < m * n; ++idx) {
    dp[idx] = sim[idx];
    accu[idx] = 0;
    back[idx] = -1;
  }
  for (int64_t i = 1; i < m; ++i) {
    const double* sim_i = sim + i * n;
    double* dp_i = dp + i * n;
    const double* dp_im1 = dp + (i - 1) * n;
    int32_t* accu_i = accu + i * n;
    const int32_t* accu_im1 = accu + (i - 1) * n;
    int8_t* back_i = back + i * n;
    for (int64_t j = 1; j < n; ++j) {
      double s = sim_i[j];
      double top_left = dp_im1[j - 1] + s;
      double top = dp_im1[j] + 0.5 * s;
      double left = dp_i[j - 1] + 0.5 * s;
      int8_t max_ind;
      double max_value;
      int32_t prev_accu;
      if (top_left >= top && top_left >= left) {
        max_ind = 0;
        max_value = top_left;
        prev_accu = accu_im1[j - 1];
      } else if (top >= left) {
        max_ind = 1;
        max_value = top;
        prev_accu = accu_im1[j];
      } else {
        max_ind = 2;
        max_value = left;
        prev_accu = accu_i[j - 1];
      }
      if (s < min_sim) {
        accu_i[j] = prev_accu + 1;
      }
      if (accu_i[j] <= discontinue) {
        back_i[j] = max_ind;
        dp_i[j] = max_value;
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// TN (temporal network) alignment — the eval path's algorithm, and the
// wall-clock bottleneck of descriptor evaluation when run in Python.
//
// Role parity (reference, for cross-checking — original implementation):
//   D1/infer/vcsl/vta.py:244-364 (`tn`): top-k matches per query frame become
//   DAG nodes, constraint-filtered edges (C1 step bound, C2 forward ref
//   motion, C3 no used intermediate ref frame, C4 min similarity), repeated
//   longest paths -> boxes with IoU NMS.
//
// Matches align/vta.py's `tn_reference` bit for bit (same tie-breaking:
// stable descending top-k, insertion-ordered predecessor lists, first-max
// argmax).

#include <algorithm>
#include <cmath>
#include <numeric>
#include <set>
#include <unordered_map>
#include <vector>

namespace {

struct TnDag {
  int64_t num_nodes;
  std::vector<std::vector<int64_t>> preds;
  std::unordered_map<int64_t, double> weights;  // key = u * num_nodes + v

  explicit TnDag(int64_t n) : num_nodes(n), preds(n) {}

  void add_edge(int64_t u, int64_t v, double w) {
    int64_t key = u * num_nodes + v;
    auto it = weights.find(key);
    if (it == weights.end()) {
      preds[v].push_back(u);
      weights.emplace(key, w);
    } else {
      it->second = w;  // overwrite (sink edges re-add with weight 0)
    }
  }

  // Longest path ending anywhere; node ids are already topologically sorted.
  std::vector<int64_t> longest_path() const {
    std::vector<double> dist(num_nodes, 0.0);
    std::vector<int64_t> parent(num_nodes, -1);
    for (int64_t v = 0; v < num_nodes; ++v) {
      double best = 0.0;
      int64_t arg = -1;
      for (int64_t u : preds[v]) {
        double cand = dist[u] + weights.at(u * num_nodes + v);
        if (cand > best) {  // strict >: first predecessor wins ties
          best = cand;
          arg = u;
        }
      }
      dist[v] = best;
      parent[v] = arg;
    }
    int64_t v = 0;
    for (int64_t i = 1; i < num_nodes; ++i) {
      if (dist[i] > dist[v]) v = i;  // first max (np.argmax semantics)
    }
    std::vector<int64_t> path{v};
    while (parent[v] != -1) {
      v = parent[v];
      path.push_back(v);
    }
    std::reverse(path.begin(), path.end());
    return path;
  }

  void zero_path(const std::vector<int64_t>& path) {
    for (size_t i = 0; i + 1 < path.size(); ++i) {
      auto it = weights.find(path[i] * num_nodes + path[i + 1]);
      if (it != weights.end()) it->second = 0.0;
    }
  }
};

inline double box_iou(const int32_t* a, const int32_t* b) {
  double lt0 = std::max(a[0], b[0]), lt1 = std::max(a[1], b[1]);
  double rb0 = std::min(a[2], b[2]), rb1 = std::min(a[3], b[3]);
  double w0 = std::max(rb0 - lt0 + 1.0, 0.0), w1 = std::max(rb1 - lt1 + 1.0, 0.0);
  double inter = w0 * w1;
  double area_a = double(a[2] - a[0] + 1) * double(a[3] - a[1] + 1);
  double area_b = double(b[2] - b[0] + 1) * double(b[3] - b[1] + 1);
  return inter / (area_a + area_b - inter);
}

}  // namespace

extern "C" {

// sims: [q_len, r_len] row-major f64. out_boxes: [max_boxes, 4] i32.
// Returns the number of boxes written.
int64_t vta_tn(const double* sims, int64_t q_len, int64_t r_len,
               int64_t tn_max_step, int64_t tn_top_k, int64_t max_path,
               double min_sim, int64_t min_length, double max_iou,
               int32_t* out_boxes, int64_t max_boxes) {
  const int64_t top = std::min(tn_top_k, r_len);
  if (top <= 0 || q_len <= 0) return 0;

  // Stable descending top-k per query row (ties -> lower ref index first).
  std::vector<int64_t> topk_idx(q_len * top);
  std::vector<double> topk_sim(q_len * top);
  {
    std::vector<int64_t> order(r_len);
    for (int64_t q = 0; q < q_len; ++q) {
      const double* row = sims + q * r_len;
      std::iota(order.begin(), order.end(), 0);
      std::stable_sort(order.begin(), order.end(),
                       [row](int64_t a, int64_t b) { return row[a] > row[b]; });
      for (int64_t k = 0; k < top; ++k) {
        topk_idx[q * top + k] = order[k];
        topk_sim[q * top + k] = row[order[k]];
      }
    }
  }

  // Node layout: 0 = source; pair (q, k) -> 1 + q*top + k; last node = sink.
  const int64_t num_nodes = 1 + q_len * top;
  const int64_t sink = num_nodes - 1;
  TnDag dag(num_nodes);

  for (int64_t qi = 0; qi < q_len; ++qi) {
    const int64_t* ri = &topk_idx[qi * top];
    std::set<int64_t> intermediates;
    for (int64_t qj = qi + 1; qj < std::min(q_len, qi + tn_max_step); ++qj) {
      const int64_t* rj = &topk_idx[qj * top];
      const double* sj = &topk_sim[qj * top];
      // row-major (dst r, src c) order matches np.where on [dst, src]
      std::vector<int64_t> passing_dst;
      for (int64_t r = 0; r < top; ++r) {
        if (sj[r] < min_sim) continue;  // C4
        bool any = false;
        for (int64_t c = 0; c < top; ++c) {
          int64_t diff = rj[r] - ri[c];
          if (diff <= 0 || diff >= tn_max_step) continue;  // C2
          // C3: no already-used intermediate ref frame strictly between.
          auto it = intermediates.upper_bound(ri[c]);
          if (it != intermediates.end() && *it < rj[r]) continue;
          dag.add_edge(1 + qi * top + c, 1 + qj * top + r, sj[r]);
          any = true;
        }
        if (any) passing_dst.push_back(rj[r]);
      }
      for (int64_t r : passing_dst) intermediates.insert(r);
    }
  }

  // Sink edges (the last pair node doubles as the sink).
  {
    int64_t sq = (sink - 1) / top;
    int64_t sr = topk_idx[sink - 1];
    for (int64_t i = 0; i < sink; ++i) {
      int64_t pq = (i == 0) ? -1 : (i - 1) / top;
      int64_t pr = (i == 0) ? -1 : topk_idx[i - 1];
      if (sq > pq && sr > pr && sq - pq <= tn_max_step && sr - pr <= tn_max_step) {
        dag.add_edge(i, sink, 0.0);
      }
    }
  }

  int64_t n_boxes = 0;
  for (int64_t iter = 0; iter < max_path + 1; ++iter) {
    std::vector<int64_t> path = dag.longest_path();
    dag.zero_path(path);
    std::vector<int64_t> nodes;
    for (int64_t v : path) {
      if (v != 0 && v != sink) nodes.push_back(v);
    }
    if (nodes.empty()) break;

    double score = 0.0;
    int64_t q_min = INT64_MAX, q_max = INT64_MIN, r_min = INT64_MAX, r_max = INT64_MIN;
    for (int64_t v : nodes) {
      int64_t q = (v - 1) / top;
      int64_t r = topk_idx[v - 1];
      score += sims[q * r_len + r];
      q_min = std::min(q_min, q);
      q_max = std::max(q_max, q);
      r_min = std::min(r_min, r);
      r_max = std::max(r_max, r);
    }
    if (score <= 0.0) {
      q_min = q_max = r_min = r_max = 0;
    }
    double ave_length = (double(r_max - r_min) + double(q_max - q_min)) / 2.0;
    int32_t box[4] = {int32_t(q_min), int32_t(r_min), int32_t(q_max), int32_t(r_max)};
    double max_found_iou = 0.0;
    for (int64_t b = 0; b < n_boxes; ++b) {
      max_found_iou = std::max(max_found_iou, box_iou(box, out_boxes + 4 * b));
    }
    if (ave_length > 0.0 && score / ave_length > min_sim &&
        std::min(r_max - r_min, q_max - q_min) > min_length &&
        max_found_iou < max_iou && n_boxes < max_boxes) {
      std::copy(box, box + 4, out_boxes + 4 * n_boxes);
      ++n_boxes;
    }
  }
  return n_boxes;
}

}  // extern "C"
