"""Geometry helpers for the ported transforms (counterpart of
`dpcr_agb_tpu/transforms/geometry.py`)."""
from __future__ import annotations

import numpy as np


def euler_angles_to_rotation_matrix(theta: np.ndarray,
                                    order=(0, 1, 2)) -> np.ndarray:
    """Rotation matrix from per-axis Euler angles, the axis matrices
    composed in the given order."""
    cx, sx = np.cos(theta[0]), np.sin(theta[0])
    cy, sy = np.cos(theta[1]), np.sin(theta[1])
    cz, sz = np.cos(theta[2]), np.sin(theta[2])
    r_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    r_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    r_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ms = [[r_x, r_y, r_z][i] for i in order]
    return (ms[2] @ ms[1] @ ms[0]).astype(np.float32)


def affine2d(scale: float = 1.0, translate=(0.0, 0.0),
             rotate_deg: float = 0.0, rotate_about=(0.5, 0.5)) -> np.ndarray:
    """3x3 homogeneous 2D affine: scale, then translate, then rotate about
    a point."""
    s_m = np.diag([scale, scale, 1.0])
    t_m = np.array([[1, 0, translate[0]], [0, 1, translate[1]], [0, 0, 1.0]])
    th = np.deg2rad(rotate_deg)
    c, s = np.cos(th), np.sin(th)
    cx, cy = rotate_about
    to_c = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    r_m = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    back = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])
    return back @ r_m @ to_c @ t_m @ s_m


def transform_points2d(a: np.ndarray, pts: np.ndarray) -> np.ndarray:
    pts_h = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (pts_h @ a.T)[:, :2]


def points_in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Vectorized even-odd-rule point-in-polygon test: points [N,2],
    polygon [V,2] (closed implicitly)."""
    points = np.asarray(points, dtype=np.float64)
    poly = np.asarray(polygon, dtype=np.float64)
    x, y = points[:, 0], points[:, 1]
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    inside = np.zeros(len(points), dtype=bool)
    for i in range(len(poly)):
        crosses = (y0[i] > y) != (y1[i] > y)
        if not crosses.any():
            continue
        xint = (x1[i] - x0[i]) * (y - y0[i]) / (y1[i] - y0[i]) + x0[i]
        inside ^= crosses & (x < xint)
    return inside


def dbscan1d_labels(z: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """1D DBSCAN labels (noise = -1) via sorting + searchsorted: a point is
    core if >= min_samples points lie within [z-eps, z+eps] (itself
    included); clusters are chains of core points closer than eps plus the
    border points within eps of a core point."""
    z = np.asarray(z, dtype=np.float64).ravel()
    n = len(z)
    order = np.argsort(z, kind="stable")
    zs = z[order]
    lo = np.searchsorted(zs, zs - eps, side="left")
    hi = np.searchsorted(zs, zs + eps, side="right")
    core = (hi - lo) >= min_samples

    labels_sorted = np.full(n, -1, dtype=np.int64)
    core_idx = np.flatnonzero(core)
    if len(core_idx):
        zc = zs[core_idx]
        new_cluster = np.concatenate([[True], np.diff(zc) > eps])
        core_labels = np.cumsum(new_cluster) - 1
        labels_sorted[core_idx] = core_labels
        pos = np.searchsorted(zc, zs)
        left = np.clip(pos - 1, 0, len(zc) - 1)
        right = np.clip(pos, 0, len(zc) - 1)
        d_left = np.abs(zs - zc[left])
        d_right = np.abs(zs - zc[right])
        nearest = np.where(d_right < d_left, right, left)
        d_near = np.minimum(d_left, d_right)
        border = (~core) & (d_near <= eps)
        labels_sorted[border] = core_labels[nearest[border]]
    labels = np.empty(n, dtype=np.int64)
    labels[order] = labels_sorted
    return labels


# -- the library-backed z-outlier and density filters, in numpy ------------

_DECIMALS = np.finfo(np.float64).precision     # OPTICS rounds its distances


def _optics_envelope(zq: np.ndarray, cq: np.ndarray,
                     zx: np.ndarray) -> np.ndarray:
    """min over q of max(|zx - zq|, cq), for sorted zq: only the q within
    the better of the two nearest q's values can reach the minimum, so
    each x looks at those alone."""
    m = len(zq)
    right = np.searchsorted(zq, zx, side="left")
    left = right - 1
    r = np.full(len(zx), np.inf)
    for side in (left, right):
        ok = (side >= 0) & (side < m)
        s = np.clip(side, 0, m - 1)
        r = np.where(ok, np.minimum(r, np.maximum(np.abs(zx - zq[s]), cq[s])),
                     r)
    slack = 1e-9 * (np.abs(zx) + r) + 1e-300
    lo = np.searchsorted(zq, zx - r - slack, side="left")
    hi = np.searchsorted(zq, zx + r + slack, side="right")
    out = np.empty(len(zx))
    counts = hi - lo
    start = 0
    while start < len(zx):      # chunks of at most ~4M (x, q) pairs
        csum = np.cumsum(counts[start:])
        stop = start + max(1, int(np.searchsorted(csum, 1 << 22)))
        c = counts[start:stop]
        rows = np.repeat(np.arange(start, stop), c)
        first = np.cumsum(c) - c
        q = lo[rows] + (np.arange(len(rows)) - np.repeat(first, c))
        vals = np.maximum(np.abs(zx[rows] - zq[q]), cq[q])
        out[start:stop] = np.minimum.reduceat(vals, first)
        start = stop
    return out


def optics_dbscan_noise(z: np.ndarray, eps: float,
                        min_samples: int) -> np.ndarray:
    """The noise mask of scikit-learn's `OPTICS(eps=eps,
    min_samples=min_samples, cluster_method="dbscan").fit_predict(z[:, None])`
    (max_eps infinite, euclidean), for 1-D z taken in float64 as
    scikit-learn takes it.

    scikit-learn's rules: a point's core distance is its min_samples-th
    nearest distance (itself included); points are processed one by one,
    each time the unprocessed point of least reachability (ties: the
    lowest index; so index 0 first, at infinity); a processed point lowers
    every unprocessed point's reachability to max(|dz|, its core
    distance); both rounded to 15 decimals. A point is noise iff its
    reachability and its core distance both exceed eps.

    So a core point (core distance <= eps) is never noise. Once a core
    point is processed, every point it reaches within eps comes next, so
    its whole cluster (core points chained by gaps <= eps) and their
    border points (non-core, within eps of one) are processed before any
    point beyond, none of them noise. Between clusters the order jumps
    to the least reachability outside; a non-core point taken in such a
    jump is noise, even when it borders a cluster not yet entered (where
    DBSCAN calls it border). This walks those jumps, a cluster at a time:
    its steps are the clusters and the noise points, not the points."""
    z = np.asarray(z, dtype=np.float64).ravel()
    n = len(z)
    if min_samples <= 1:
        min_samples = max(2, int(min_samples * n))
    if not 1 <= min_samples <= n:
        raise ValueError(f"min_samples must be no greater than the number "
                         f"of samples ({n}); got {min_samples}")
    order = np.argsort(z, kind="stable")
    zs = z[order]
    k = int(min_samples)
    core = np.full(n, np.inf)       # sorted order
    i = np.arange(n)
    for t in range(k):              # the k-window starting at i - t
        j = i - t
        ok = (j >= 0) & (j <= n - k)
        jj = np.clip(j, 0, n - k)
        d = np.maximum(zs - zs[jj], zs[jj + k - 1] - zs)
        core = np.where(ok, np.minimum(core, d), core)
    core = np.around(core, decimals=_DECIMALS)
    is_core = core <= eps
    cidx = np.flatnonzero(is_core)
    cluster = np.full(n, -1)        # of core points
    border = np.full((2, n), -1)    # the clusters a non-core point borders
    if len(cidx):
        gap = np.around(np.diff(zs[cidx]), decimals=_DECIMALS) > eps
        cluster[cidx] = np.cumsum(np.concatenate([[False], gap]))
        nxt = np.searchsorted(cidx, i, side="left")
        for row, s in enumerate((nxt - 1, nxt)):
            ok = (s >= 0) & (s < len(cidx)) & ~is_core
            q = cidx[np.clip(s, 0, len(cidx) - 1)]
            reach = np.around(np.maximum(np.abs(zs - zs[q]), core[q]),
                              decimals=_DECIMALS)
            border[row] = np.where(ok & (reach <= eps), cluster[q], -1)
    done = np.zeros(n, dtype=bool)
    noise = np.zeros(n, dtype=bool)
    reach = np.full(n, np.inf)
    while not done.all():
        todo = np.flatnonzero(~done)
        r = reach[todo]
        tied = todo[r == r.min()]
        p = tied[np.argmin(order[tied])]
        if is_core[p]:
            c = cluster[p]
            new = ~done & ((cluster == c) | (border[0] == c)
                           | (border[1] == c))
        else:
            noise[p] = True
            new = np.zeros(n, dtype=bool)
            new[p] = True
        done |= new
        rest = np.flatnonzero(~done)
        if len(rest):
            q = np.flatnonzero(new)
            reach[rest] = np.minimum(reach[rest], np.around(
                _optics_envelope(zs[q], core[q], zs[rest]),
                decimals=_DECIMALS))
    out = np.empty(n, dtype=bool)
    out[order] = noise
    return out


def gaussian_kde_log_density(data: np.ndarray, query: np.ndarray,
                             bandwidth: float) -> np.ndarray:
    """scikit-learn's `KernelDensity(kernel="gaussian", bandwidth).fit(
    data[:, None]).score_samples(query[:, None])` for 1-D float64 data:
    log(sum_j exp(-(q - x_j)^2 / 2h^2)) - log N - log(h sqrt(2 pi)), every
    term summed (scikit-learn's tree drops only those that are 0 in f64,
    at its default atol = rtol = 0), in another order."""
    data = np.asarray(data, dtype=np.float64).ravel()
    query = np.asarray(query, dtype=np.float64).ravel()
    h = float(bandwidth)
    log_norm = -0.5 * np.log(2 * np.pi) - np.log(h)
    out = np.empty(len(query))
    step = max(1, (1 << 22) // max(1, len(data)))
    for s in range(0, len(query), step):
        d = query[s:s + step, None] - data[None, :]
        out[s:s + step] = np.log(np.exp(-0.5 * (d * d) / (h * h)).sum(1))
    return out + log_norm - np.log(len(data))


def radius_counts(pos: np.ndarray, radius: float) -> np.ndarray:
    """For each point, the points (itself included) at distance <= radius,
    as scikit-learn's `KDTree(pos).query_radius(pos, radius,
    count_only=True)` counts them: squared distances summed over x, y, z
    in float64 of the positions, compared with radius^2. A grid of cells a
    little wider than the radius: a point's neighbours lie in the 27 cells
    around its own."""
    p = np.asarray(pos, dtype=np.float64)
    n = len(p)
    r = float(radius)
    if r < 0:
        raise ValueError(f"radius {r} < 0")
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if r == 0:      # coincident points only
        _, inv, cnt = np.unique(p, axis=0, return_inverse=True,
                                return_counts=True)
        return cnt[inv.ravel()].astype(np.int64)
    cell = np.floor((p - p.min(0)) / (r * (1 + 2.0 ** -20))).astype(np.int64)
    radix = cell.max(0) + 3
    key = ((cell[:, 0] + 1) * radix[1] + cell[:, 1] + 1) * radix[2] \
        + cell[:, 2] + 1
    order = np.argsort(key, kind="stable")
    skey = key[order]
    rr = r * r
    counts = np.zeros(n, dtype=np.int64)
    offs = [(a * radix[1] + b) * radix[2] + c for a in (-1, 0, 1)
            for b in (-1, 0, 1) for c in (-1, 0, 1)]
    for off in offs:
        lo = np.searchsorted(skey, key + off, side="left")
        hi = np.searchsorted(skey, key + off, side="right")
        c = hi - lo
        start = 0
        while start < n:        # chunks of at most ~4M pairs
            csum = np.cumsum(c[start:])
            stop = start + max(1, int(np.searchsorted(csum, 1 << 22)))
            cc = c[start:stop]
            rows = np.repeat(np.arange(start, stop), cc)
            first = np.cumsum(cc) - cc
            j = order[lo[rows] + (np.arange(len(rows))
                                  - np.repeat(first, cc))]
            d = p[rows] - p[j]
            d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
            counts[start:stop] += np.bincount(rows - start,
                                              weights=d2 <= rr,
                                              minlength=stop - start
                                              ).astype(np.int64)
            start = stop
    return counts
