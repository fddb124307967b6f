"""Kernel-point dispositions of KPConv (the port's own numpy copy of
`dpcr_agb_tpu/ops/kernel_points.py`; reference
modules/KPConv/kernel_points.py:38-413).

Two generators, matching the reference's split (kernel_points.py:339-375):

* `potential_descent` (K<=30 default, the reference's
  `kernel_point_optimization_debug` path, :204-337): minimizes a repulsive
  1/r inter-point potential plus an attractive radial potential by clipped
  gradient descent over many random candidates, keeps the candidate with the
  lowest final max-gradient norm, and rescales so the mean non-center radius
  is 0.66. This is what the paper's K=15 kernels use.
* `spherical_lloyd` (K>30, kernel_points.py:72-203): Monte-Carlo Lloyd.

`load_kernel_points` reads the unit disposition from the tracked `.npy`
files in `kernel_dispositions/` beside this module (copies of the JAX
package's), or generates it in memory when there is none: it writes no
file. Load-time behavior matches: random z-rotation + N(0, 0.01) jitter
from `seed`, scale by the block radius (kernel_points.py:376-411).
`DPCR_KP_DISPOSITION` overrides the K-based choice ('lloyd' | 'descent').
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "kernel_dispositions")


def spherical_lloyd(radius: float, num_points: int, fixed: str = "center",
                    n_iter: int = 60, n_samples: int = 40000,
                    seed: int = 42) -> np.ndarray:
    """Quasi-uniform points in a ball via Lloyd relaxation on Monte-Carlo
    samples. `fixed`: 'none' | 'center' | 'verticals' pins points like the
    reference (kernel_points.py:89-117)."""
    rng = np.random.RandomState(seed)
    dim = 3

    # initial points: random in ball
    pts = np.zeros((0, dim))
    while pts.shape[0] < num_points:
        cand = rng.uniform(-radius, radius, size=(2 * num_points, dim))
        cand = cand[np.linalg.norm(cand, axis=1) < radius]
        pts = np.concatenate([pts, cand])[:num_points]

    n_fixed = 0
    if fixed in ("center", "verticals"):
        pts[0] = 0.0
        n_fixed = 1
    if fixed == "verticals":
        pts[1] = [0, 0, radius / 2]
        pts[2] = [0, 0, -radius / 2]
        n_fixed = 3

    for _ in range(n_iter):
        samples = rng.uniform(-radius, radius, size=(n_samples, dim))
        samples = samples[np.linalg.norm(samples, axis=1) < radius]
        d2 = ((samples[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        owner = d2.argmin(axis=1)
        for i in range(n_fixed, num_points):
            members = samples[owner == i]
            if len(members):
                pts[i] = members.mean(axis=0)
        if fixed == "verticals":  # keep the vertical pair on the z axis
            pts[1, :2] = 0.0
            pts[2, :2] = 0.0
    return pts.astype(np.float32)


def potential_descent(num_points: int, fixed: str = "center",
                      n_candidates: int = 100, ratio: float = 0.66,
                      max_steps: int = 10000, seed: int = 42) -> np.ndarray:
    """Best-of-N potential-minimizing disposition in the unit ball
    (reference kernel_points.py:204-337 semantics, vectorized over all
    candidates: [C,K,3] instead of the reference's per-kernel python loop).

    Energy: sum_ij 1/|p_i - p_j|  +  5 * sum_i |p_i|^2  (whose gradients are
    the reference's `inter_grads` and `circle_grads = 10 * p`). Points move
    against the normalized gradient by a clipped, decaying step. The
    candidate whose final max moving-point gradient norm is smallest wins.
    Output is rescaled so mean(|p_i|, i>0) == ratio (0.66)."""
    rng = np.random.RandomState(seed)
    dim = 3

    # init: uniform in the radius*sqrt(0.5) ball (matches the reference's
    # d2 < 0.5 rejection bound)
    pts = np.zeros((0, dim))
    need = n_candidates * num_points
    while pts.shape[0] < need:
        cand = rng.uniform(-1, 1, size=(2 * need, dim))
        cand = cand[(cand ** 2).sum(1) < 0.5]
        pts = np.concatenate([pts, cand])[:need]
    kp = pts.reshape(n_candidates, num_points, dim)

    n_fixed = 0
    if fixed in ("center", "verticals"):
        kp[:, 0] = 0.0
        n_fixed = 1
    if fixed == "verticals":
        kp[:, 1] = [0, 0, 2.0 / 3.0]
        kp[:, 2] = [0, 0, -2.0 / 3.0]
        n_fixed = 3

    lr, decay, clip, thresh = 1e-2, 0.9995, 0.05, 1e-5
    old_norms = np.zeros((n_candidates, num_points))
    for _ in range(max_steps):
        diff = kp[:, :, None, :] - kp[:, None, :, :]          # [C,K,K,3]
        d2 = (diff ** 2).sum(-1)
        inter = (diff / (d2[..., None] ** 1.5 + 1e-6)).sum(2)  # [C,K,3]
        # Reference sign convention (kernel_points.py:273-283): its
        # inter_grads sum over axis 1 gives sum_i (p_i - p_j)/d^3 at point
        # j, i.e. MINUS the repulsion direction, and the update then
        # SUBTRACTS the gradient — so points move apart. Our `inter` sums
        # over axis 2 (= +repulsion at point i), so it must enter the
        # gradient NEGATED; round 1-4 had `inter + 10*kp`, which made the
        # update ATTRACT points: K=15 dispositions collapsed into a
        # 6-point clump at r~0.05 plus a blown-out hemisphere shell at
        # r~1.1 (min pairwise distance 0.024), measured -0.31 test R2 vs
        # Lloyd on the round-5 disposition A/B before the fix.
        grads = 10.0 * kp - inter
        if fixed == "verticals":  # vertical pair moves only along z
            grads[:, 1:3, :2] = 0.0
        norms = np.sqrt((grads ** 2).sum(-1))                  # [C,K]
        moving = norms[:, max(n_fixed, 1):] if n_fixed else norms
        old_moving = (old_norms[:, max(n_fixed, 1):]
                      if n_fixed else old_norms)
        if np.max(np.abs(old_moving - moving)) < thresh:
            break
        old_norms = norms.copy()
        step = np.minimum(lr * norms, clip)
        if n_fixed:
            step[:, :n_fixed] = 0.0
        kp -= step[..., None] * grads / (norms[..., None] + 1e-6)
        lr *= decay

    # candidate selection: lowest final max gradient among moving points
    sel = norms[:, n_fixed:].max(1).argmin() if n_fixed \
        else norms.max(1).argmin()
    best = kp[sel]
    r = np.sqrt((best ** 2).sum(-1))
    best = best * (ratio / max(r[1:].mean(), 1e-9))
    return best.astype(np.float32)


@lru_cache(maxsize=None)
def _unit_disposition(num_points: int, fixed: str, method: str) -> np.ndarray:
    """The unit-radius disposition: the tracked file, else generated."""
    tag = "" if method == "lloyd" else "_gd"
    path = os.path.join(_DIR, f"k_{num_points:03d}_{fixed}{tag}_3D.npy")
    if os.path.exists(path):
        return np.load(path)
    if method == "descent":
        return potential_descent(num_points, fixed=fixed)
    return spherical_lloyd(1.0, num_points, fixed=fixed)


def load_kernel_points(radius: float, num_points: int, fixed: str = "center",
                       seed: Optional[int] = None,
                       jitter: float = 0.01,
                       method: str = "auto") -> np.ndarray:
    """[K,3] disposition scaled to `radius`, with the reference's load-time
    random z-rotation + jitter (deterministic here via `seed`).

    `method='auto'` mirrors the reference's load_kernels rule
    (kernel_points.py:339-375): potential descent for K<=30 (the paper's
    K=15 path), Lloyd above. The model plumbs this from config
    (KPCNN.kp_disposition) so checkpoints record it; the
    `DPCR_KP_DISPOSITION=lloyd|descent` env override exists for A/B
    experiments."""
    env = os.environ.get("DPCR_KP_DISPOSITION", "")
    if env in ("lloyd", "descent"):
        method = env
    if method not in ("lloyd", "descent"):
        method = "descent" if num_points <= 30 else "lloyd"
    pts = _unit_disposition(num_points, fixed, method)

    rng = np.random.RandomState(0 if seed is None else seed)
    theta = rng.rand() * 2 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
    pts = pts + rng.normal(scale=jitter, size=pts.shape)
    pts = radius * pts
    return (pts @ rot).astype(np.float32)
