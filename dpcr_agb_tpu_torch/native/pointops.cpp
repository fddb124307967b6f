// Host point ops: a copy of the JAX package's native/pointops.cpp, so that
// the port builds the same pyramids, bit for bit, as the JAX package's
// native path. The point half (voxel-barycentre grid subsampling and radius
// neighbours over a flat spatial hash or a flat cell grid) serves the KPConv
// pyramid; the sparse-voxel key half (sorted keys, kernel maps by binary
// search, strided downsampling) serves the sparse-voxel nets' map mode.
//
// C interface for ctypes; every buffer is a caller-allocated numpy array.
#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

struct CellKey {
    int32_t x, y, z;
    bool operator==(const CellKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct CellHash {
    size_t operator()(const CellKey& k) const {
        // 3D integer hash (large primes)
        return (size_t)k.x * 73856093u ^ (size_t)k.y * 19349663u
             ^ (size_t)k.z * 83492791u;
    }
};

inline CellKey cell_of(const float* p, float inv) {
    return CellKey{(int32_t)std::floor(p[0] * inv),
                   (int32_t)std::floor(p[1] * inv),
                   (int32_t)std::floor(p[2] * inv)};
}

}  // namespace

extern "C" {

// Voxel-barycenter grid subsampling (reference grid_subsampling.cpp:5-106):
// one output point per occupied voxel = mean of member positions (and
// features). Returns the number of output points (<= n_max_out).
// points [n,3] f32; feats [n,c] f32 or null; out_points [n_max_out,3];
// out_feats [n_max_out,c] or null.
int64_t grid_subsample(const float* points, int64_t n, const float* feats,
                       int64_t c, float dl, float* out_points,
                       float* out_feats, int64_t n_max_out) {
    std::unordered_map<CellKey, int64_t, CellHash> cells;
    cells.reserve((size_t)n);
    std::vector<double> acc_p;
    std::vector<double> acc_f;
    std::vector<int64_t> counts;
    const float inv = 1.0f / dl;
    for (int64_t i = 0; i < n; ++i) {
        CellKey key = cell_of(points + 3 * i, inv);
        auto it = cells.find(key);
        int64_t idx;
        if (it == cells.end()) {
            idx = (int64_t)counts.size();
            if (idx >= n_max_out) continue;  // deterministic drop at cap
            cells.emplace(key, idx);
            acc_p.resize(3 * (idx + 1), 0.0);
            if (feats) acc_f.resize(c * (idx + 1), 0.0);
            counts.push_back(0);
        } else {
            idx = it->second;
        }
        counts[idx]++;
        for (int d = 0; d < 3; ++d) acc_p[3 * idx + d] += points[3 * i + d];
        if (feats)
            for (int64_t d = 0; d < c; ++d)
                acc_f[c * idx + d] += feats[c * i + d];
    }
    int64_t n_out = (int64_t)counts.size();
    for (int64_t j = 0; j < n_out; ++j) {
        for (int d = 0; d < 3; ++d)
            out_points[3 * j + d] = (float)(acc_p[3 * j + d] / counts[j]);
        if (feats && out_feats)
            for (int64_t d = 0; d < c; ++d)
                out_feats[c * j + d] = (float)(acc_f[c * j + d] / counts[j]);
    }
    return n_out;
}

// Radius neighbors, sorted ascending by distance, padded with n_s (shadow)
// — semantics of neighbors.cpp:211-332 + the neighborhood_limits crop.
// queries [n_q,3], supports [n_s,3], out [n_q, max_k] int32.
static void radius_neighbors_hash(const float* queries, int64_t n_q,
                                  const float* supports, int64_t n_s,
                                  float radius, int32_t max_k, int32_t* out) {
    std::unordered_map<CellKey, std::vector<int32_t>, CellHash> grid;
    grid.reserve((size_t)n_s);
    const float inv = 1.0f / radius;
    for (int64_t i = 0; i < n_s; ++i)
        grid[cell_of(supports + 3 * i, inv)].push_back((int32_t)i);

    const float r2 = radius * radius;
    std::vector<std::pair<float, int32_t>> cand;
    for (int64_t q = 0; q < n_q; ++q) {
        cand.clear();
        const float* qp = queries + 3 * q;
        CellKey base = cell_of(qp, inv);
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    auto it = grid.find(CellKey{base.x + dx, base.y + dy,
                                                base.z + dz});
                    if (it == grid.end()) continue;
                    for (int32_t s : it->second) {
                        const float* sp = supports + 3 * s;
                        float d0 = qp[0] - sp[0], d1 = qp[1] - sp[1],
                              d2 = qp[2] - sp[2];
                        float d = d0 * d0 + d1 * d1 + d2 * d2;
                        if (d < r2) cand.emplace_back(d, s);
                    }
                }
        int32_t k = (int32_t)std::min((size_t)max_k, cand.size());
        std::partial_sort(cand.begin(), cand.begin() + k, cand.end());
        int32_t* row = out + (size_t)q * max_k;
        for (int32_t j = 0; j < k; ++j) row[j] = cand[j].second;
        for (int32_t j = k; j < max_k; ++j) row[j] = (int32_t)n_s;
    }
}

// Flat-grid variant: bucket supports into a dense [nx*ny*nz] cell array via
// counting sort (two passes, zero allocations per cell), then scan the 27
// neighboring cells per query. Candidate scans touch contiguous memory —
// measured several-fold faster than the hash-of-vectors layout that this
// replaces. Falls back to the hash path when the support extent would make
// the dense cell array large relative to n_s (pathological spreads).
void radius_neighbors(const float* queries, int64_t n_q,
                      const float* supports, int64_t n_s, float radius,
                      int32_t max_k, int32_t* out) {
    if (n_q <= 0) return;
    if (n_s <= 0) {
        for (int64_t q = 0; q < n_q; ++q)
            for (int32_t j = 0; j < max_k; ++j)
                out[(size_t)q * max_k + j] = 0;
        return;
    }
    const float inv = 1.0f / radius;
    // Extents over FINITE coords only: NaN/inf points (corrupt LAS rows,
    // augmentation overflow) must not poison the grid geometry. They are
    // clamped into edge cells below, where their NaN/inf distance excludes
    // them from every radius test — matching the hash path's tolerance.
    float lo[3], hi[3];
    bool any_finite = false;
    for (int d = 0; d < 3; ++d) { lo[d] = 0.0f; hi[d] = 0.0f; }
    for (int64_t i = 0; i < n_s; ++i) {
        const float* p = supports + 3 * i;
        if (!std::isfinite(p[0]) || !std::isfinite(p[1]) ||
            !std::isfinite(p[2]))
            continue;
        if (!any_finite) {
            for (int d = 0; d < 3; ++d) { lo[d] = p[d]; hi[d] = p[d]; }
            any_finite = true;
            continue;
        }
        for (int d = 0; d < 3; ++d) {
            if (p[d] < lo[d]) lo[d] = p[d];
            if (p[d] > hi[d]) hi[d] = p[d];
        }
    }
    if (!any_finite) {  // nothing can ever be within radius
        for (int64_t q = 0; q < n_q; ++q)
            for (int32_t j = 0; j < max_k; ++j)
                out[(size_t)q * max_k + j] = (int32_t)n_s;
        return;
    }
    int64_t dims[3];
    for (int d = 0; d < 3; ++d) {
        dims[d] = (int64_t)std::floor((hi[d] - lo[d]) * inv) + 1;
        if (dims[d] < 1) dims[d] = 1;
    }
    int64_t n_cells = dims[0] * dims[1] * dims[2];
    // The start[] array costs 4 bytes/cell, so generously empty grids are
    // still cheap (an NFI plot at the level-0 search radius is ~150k cells
    // for ~6k points = 600 KB — well worth the contiguous scans). Fall back
    // only when the spread is truly pathological or unbounded.
    if (n_cells > 32 * n_s + (1 << 20) || n_cells > (1 << 23)) {
        radius_neighbors_hash(queries, n_q, supports, n_s, radius, max_k,
                              out);
        return;
    }
    // counting sort of support ids by cell
    std::vector<int32_t> cell_of_pt((size_t)n_s);
    std::vector<int32_t> start((size_t)n_cells + 1, 0);
    const int64_t sy = dims[2], sx = dims[1] * dims[2];
    // cell index clamped into the grid; non-finite coords land in cell 0
    // (their distance to any query is NaN/inf, so they are never selected)
    auto cell_clamped = [inv](float v, float l, int64_t dim) -> int64_t {
        float t = (v - l) * inv;
        if (!(t > 0.0f)) return 0;            // NaN, -inf, or <= lo
        if (t >= (float)dim) return dim - 1;  // +inf or > hi
        return (int64_t)t;
    };
    for (int64_t i = 0; i < n_s; ++i) {
        const float* p = supports + 3 * i;
        int64_t cx = cell_clamped(p[0], lo[0], dims[0]);
        int64_t cy = cell_clamped(p[1], lo[1], dims[1]);
        int64_t cz = cell_clamped(p[2], lo[2], dims[2]);
        int32_t c = (int32_t)(cx * sx + cy * sy + cz);
        cell_of_pt[(size_t)i] = c;
        start[(size_t)c + 1]++;
    }
    for (int64_t c = 0; c < n_cells; ++c) start[(size_t)c + 1] += start[(size_t)c];
    std::vector<int32_t> ids((size_t)n_s);
    {
        std::vector<int32_t> cursor(start.begin(), start.end() - 1);
        for (int64_t i = 0; i < n_s; ++i)
            ids[(size_t)cursor[(size_t)cell_of_pt[(size_t)i]]++] = (int32_t)i;
    }
    // gather coords into cell-sorted order so the scan below runs over
    // CONTIGUOUS xyz triples (no ids[] indirection in the hot loop)
    std::vector<float> sorted_pts((size_t)n_s * 3);
    for (int64_t t = 0; t < n_s; ++t) {
        const float* p = supports + 3 * (int64_t)ids[(size_t)t];
        sorted_pts[(size_t)t * 3] = p[0];
        sorted_pts[(size_t)t * 3 + 1] = p[1];
        sorted_pts[(size_t)t * 3 + 2] = p[2];
    }
    const float r2 = radius * radius;
    std::vector<std::pair<float, int32_t>> cand;
    cand.reserve(256);
    for (int64_t q = 0; q < n_q; ++q) {
        cand.clear();
        const float* qp = queries + 3 * q;
        // non-finite / far-out query coords -> an out-of-range cell so the
        // overlap test below yields an empty row (sentinels sized to keep
        // bx+1 / bx-1 overflow-free)
        auto qcell = [inv](float v, float l) -> int64_t {
            float t = (v - l) * inv;
            if (t != t) return INT64_MIN / 4;             // NaN
            if (t >= 9.0e17f) return INT64_MAX / 4;
            if (t <= -9.0e17f) return INT64_MIN / 4;
            return (int64_t)std::floor(t);
        };
        int64_t bx = qcell(qp[0], lo[0]);
        int64_t by = qcell(qp[1], lo[1]);
        int64_t bz = qcell(qp[2], lo[2]);
        int64_t x0 = bx > 0 ? bx - 1 : 0, x1 = bx + 1 < dims[0] ? bx + 1 : dims[0] - 1;
        int64_t y0 = by > 0 ? by - 1 : 0, y1 = by + 1 < dims[1] ? by + 1 : dims[1] - 1;
        int64_t z0 = bz > 0 ? bz - 1 : 0, z1 = bz + 1 < dims[2] ? bz + 1 : dims[2] - 1;
        if (bx + 1 >= 0 && bx - 1 < dims[0] && by + 1 >= 0 &&
            by - 1 < dims[1] && bz + 1 >= 0 && bz - 1 < dims[2]) {
            for (int64_t cx = x0; cx <= x1; ++cx)
                for (int64_t cy = y0; cy <= y1; ++cy) {
                    int64_t c0 = cx * sx + cy * sy + z0;
                    int32_t a = start[(size_t)c0];
                    int32_t b = start[(size_t)(c0 + (z1 - z0) + 1)];
                    for (int32_t t = a; t < b; ++t) {
                        const float* sp = &sorted_pts[(size_t)t * 3];
                        float d0 = qp[0] - sp[0], d1 = qp[1] - sp[1],
                              d2 = qp[2] - sp[2];
                        float d = d0 * d0 + d1 * d1 + d2 * d2;
                        if (d < r2) cand.emplace_back(d, ids[(size_t)t]);
                    }
                }
        }
        int32_t k = (int32_t)std::min((size_t)max_k, cand.size());
        std::partial_sort(cand.begin(), cand.begin() + k, cand.end());
        int32_t* row = out + (size_t)q * max_k;
        for (int32_t j = 0; j < k; ++j) row[j] = cand[j].second;
        for (int32_t j = k; j < max_k; ++j) row[j] = (int32_t)n_s;
    }
}

// Batched variant of grid_subsample over concatenated clouds
// (grid_subsampling.cpp:109-211): lengths [b] -> out_lengths [b].
void batch_grid_subsample(const float* points, const int64_t* lengths,
                          int64_t b, float dl, float* out_points,
                          int64_t* out_lengths, int64_t n_max_out_per) {
    int64_t in_off = 0, out_off = 0;
    for (int64_t i = 0; i < b; ++i) {
        out_lengths[i] = grid_subsample(points + 3 * in_off, lengths[i],
                                        nullptr, 0, dl,
                                        out_points + 3 * out_off, nullptr,
                                        n_max_out_per);
        in_off += lengths[i];
        out_off += out_lengths[i];
    }
}

}  // extern "C"

// ---- sparse-voxel pyramid primitives (ops/host_pyramid.py) ----
// Key packing matches ops/voxel.py pack_keys: 10 bits an axis, offset 512,
// sentinel 1<<30; the keys are held in int64.

static const int64_t kSentinel = int64_t(1) << 30;

static inline int64_t pack_key(const int32_t* c) {
    auto clip = [](int32_t v) {
        return (int64_t)(v < -512 ? -512 : (v > 511 ? 511 : v)) + 512;
    };
    return (clip(c[0]) << 20) | (clip(c[1]) << 10) | clip(c[2]);
}

extern "C" {

// keys_sorted [v], order [v] outputs; stable sort by key.
void build_sorted_keys(const int32_t* coords, const uint8_t* mask, int64_t v,
                       int64_t* keys_sorted, int32_t* order) {
    std::vector<std::pair<int64_t, int32_t>> kv((size_t)v);
    for (int64_t i = 0; i < v; ++i)
        kv[i] = {mask[i] ? pack_key(coords + 3 * i) : kSentinel, (int32_t)i};
    std::stable_sort(kv.begin(), kv.end(),
                     [](const auto& a, const auto& b) {
                         return a.first < b.first;
                     });
    for (int64_t i = 0; i < v; ++i) {
        keys_sorted[i] = kv[i].first;
        order[i] = kv[i].second;
    }
}

// out [k, v_out] int32: index into the input level, v_in = shadow.
// base_keys: packed keys of stride*out_coords (kSentinel where invalid).
void key_kernel_map(const int64_t* keys_sorted, const int32_t* order,
                    int64_t v_in, const int64_t* base_keys,
                    const int64_t* off_keys, int64_t k, int64_t v_out,
                    int32_t* out) {
    for (int64_t ki = 0; ki < k; ++ki) {
        int64_t off = off_keys[ki];
        int32_t* row = out + ki * v_out;
        for (int64_t q = 0; q < v_out; ++q) {
            int64_t bk = base_keys[q];
            if (bk == kSentinel) { row[q] = (int32_t)v_in; continue; }
            int64_t pk = bk + off;
            const int64_t* it = std::lower_bound(keys_sorted,
                                                 keys_sorted + v_in, pk);
            row[q] = (it != keys_sorted + v_in && *it == pk)
                         ? order[it - keys_sorted] : (int32_t)v_in;
        }
    }
}

// unique(floor(coords/stride)) in ascending-key order, capped at v_out_cap.
// Returns count written; out_coords [v_out_cap,3], out_mask [v_out_cap].
int64_t downsample_coords(const int32_t* coords, const uint8_t* mask,
                          int64_t v, int32_t stride, int64_t v_out_cap,
                          int32_t* out_coords, uint8_t* out_mask) {
    std::vector<int64_t> keys;
    keys.reserve((size_t)v);
    for (int64_t i = 0; i < v; ++i) {
        if (!mask[i]) continue;
        int32_t d[3];
        for (int j = 0; j < 3; ++j) {
            int32_t c = coords[3 * i + j];
            // floor division for negatives
            d[j] = (c >= 0) ? c / stride : -((-c + stride - 1) / stride);
        }
        keys.push_back(pack_key(d));
    }
    std::sort(keys.begin(), keys.end());
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
    int64_t n = std::min<int64_t>((int64_t)keys.size(), v_out_cap);
    for (int64_t i = 0; i < n; ++i) {
        int64_t key = keys[i];
        out_coords[3 * i + 0] = (int32_t)((key >> 20) & 1023) - 512;
        out_coords[3 * i + 1] = (int32_t)((key >> 10) & 1023) - 512;
        out_coords[3 * i + 2] = (int32_t)(key & 1023) - 512;
        out_mask[i] = 1;
    }
    for (int64_t i = n; i < v_out_cap; ++i) {
        out_coords[3 * i] = out_coords[3 * i + 1] = out_coords[3 * i + 2] = 0;
        out_mask[i] = 0;
    }
    return n;
}

}  // extern "C"
