// A 2-D KD-tree that returns radius-query points in the order of
// scikit-learn's KDTree (leaf_size 40, Euclidean metric), for the dataset's
// plot cuts: the points of a plot come out in the tree's order, and that
// order decides which point a voxel keeps (GridSampling3D mode "last") and
// which point each per-point augmentation draw lands on.
//
// The build copies scikit-learn's (sklearn/neighbors/_binary_tree.pxi.tp,
// _partition_nodes.pyx): n_levels = int(log2(max(1, (n-1)/leaf_size)) + 1),
// n_nodes = 2^n_levels - 1, nodes 2i+1 / 2i+2, a node is a leaf once
// 2i+1 >= n_nodes; an inner node splits on the first dimension of largest
// spread with std::nth_element at n/2 under the comparator "value, then
// index". The query copies its depth-first radius query with the node
// bounds (kd_tree.pyx.tp min_max_dist): a node wholly outside r is pruned,
// a node wholly inside adds its points as they lie, a leaf tests each
// point's squared distance against r*r.
//
// C interface, all arrays owned by the caller:
//   kd_build(data[n*2], n, leaf_size, idx[n], start[m], end[m], leaf[m],
//            bounds[m*4]) -> m (the node count; sizes from kd_node_count)
//   kd_query_radius(data, idx, start, end, leaf, bounds, m, cx, cy, r,
//                   out[n]) -> number of indices written to out
#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

struct Tree {
  const double* data;
  int64_t* idx;
  int64_t* start;
  int64_t* end;
  uint8_t* leaf;
  double* bounds;  // per node: lo_x, lo_y, hi_x, hi_y
  int64_t n_nodes;
};

void init_node(Tree& t, int64_t node, int64_t s, int64_t e) {
  double* b = t.bounds + 4 * node;
  b[0] = b[1] = INFINITY;
  b[2] = b[3] = -INFINITY;
  for (int64_t i = s; i < e; ++i) {
    const double* row = t.data + 2 * t.idx[i];
    for (int j = 0; j < 2; ++j) {
      b[j] = std::fmin(b[j], row[j]);
      b[2 + j] = std::fmax(b[2 + j], row[j]);
    }
  }
  t.start[node] = s;
  t.end[node] = e;
}

void build(Tree& t, int64_t node, int64_t s, int64_t e) {
  init_node(t, node, s, e);
  int64_t n = e - s;
  if (2 * node + 1 >= t.n_nodes || n < 2) {
    t.leaf[node] = 1;
    return;
  }
  t.leaf[node] = 0;
  int64_t* idx = t.idx + s;
  int dim = 0;
  double max_spread = 0.0;
  for (int j = 0; j < 2; ++j) {
    double hi = t.data[2 * idx[0] + j], lo = hi;
    for (int64_t i = 1; i < n; ++i) {
      double v = t.data[2 * idx[i] + j];
      hi = std::fmax(hi, v);
      lo = std::fmin(lo, v);
    }
    if (hi - lo > max_spread) {
      max_spread = hi - lo;
      dim = j;
    }
  }
  const double* d = t.data;
  std::nth_element(idx, idx + n / 2, idx + n,
                   [d, dim](int64_t a, int64_t b) {
                     double va = d[2 * a + dim], vb = d[2 * b + dim];
                     return va == vb ? a < b : va < vb;
                   });
  build(t, 2 * node + 1, s, s + n / 2);
  build(t, 2 * node + 2, s + n / 2, e);
}

int64_t query(const Tree& t, int64_t node, double cx, double cy, double r,
              int64_t* out, int64_t count) {
  const double* b = t.bounds + 4 * node;
  const double pt[2] = {cx, cy};
  double lb = 0.0, ub = 0.0;
  for (int j = 0; j < 2; ++j) {
    double d_lo = b[j] - pt[j];
    double d_hi = pt[j] - b[2 + j];
    double d = (d_lo + std::fabs(d_lo)) + (d_hi + std::fabs(d_hi));
    lb += std::pow(0.5 * d, 2.0);
    ub += std::pow(std::fmax(std::fabs(d_lo), std::fabs(d_hi)), 2.0);
  }
  lb = std::pow(lb, 0.5);
  ub = std::pow(ub, 0.5);
  if (lb > r) return count;
  if (ub <= r) {
    for (int64_t i = t.start[node]; i < t.end[node]; ++i) out[count++] = t.idx[i];
    return count;
  }
  if (t.leaf[node]) {
    double rr = r * r;
    for (int64_t i = t.start[node]; i < t.end[node]; ++i) {
      const double* row = t.data + 2 * t.idx[i];
      double dx = pt[0] - row[0], dy = pt[1] - row[1];
      double dist = 0.0;
      dist += dx * dx;
      dist += dy * dy;
      if (dist <= rr) out[count++] = t.idx[i];
    }
    return count;
  }
  count = query(t, 2 * node + 1, cx, cy, r, out, count);
  return query(t, 2 * node + 2, cx, cy, r, out, count);
}

}  // namespace

extern "C" {

int64_t kd_node_count(int64_t n, int64_t leaf_size) {
  double ratio = std::fmax(1.0, static_cast<double>(n - 1) / leaf_size);
  int64_t levels = static_cast<int64_t>(std::log2(ratio) + 1);
  return (int64_t{1} << levels) - 1;
}

int64_t kd_build(const double* data, int64_t n, int64_t leaf_size,
                 int64_t* idx, int64_t* start, int64_t* end, uint8_t* leaf,
                 double* bounds) {
  Tree t{data, idx, start, end, leaf, bounds, kd_node_count(n, leaf_size)};
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  if (n > 0) build(t, 0, 0, n);
  return t.n_nodes;
}

int64_t kd_query_radius(const double* data, const int64_t* idx,
                        const int64_t* start, const int64_t* end,
                        const uint8_t* leaf, const double* bounds,
                        int64_t n_nodes, double cx, double cy, double r,
                        int64_t* out) {
  Tree t{data, const_cast<int64_t*>(idx), const_cast<int64_t*>(start),
         const_cast<int64_t*>(end), const_cast<uint8_t*>(leaf),
         const_cast<double*>(bounds), n_nodes};
  if (start[0] == end[0]) return 0;
  return query(t, 0, cx, cy, r, out, 0);
}

}  // extern "C"
