"""Synthetic airborne-LiDAR forest generator (counterpart of
`dpcr_agb_tpu/data/synthetic.py`): cylindrical plots of ground + tree-crown
points with plot-level biomass/volume targets from an allometric model, and
an NFI-shaped dataset of such plots (per-plot .las files and a label
table) that `data.synthetic=true` configs generate on first use, and a
treeDB of single trees for the treeadd presets (`generate_tree_db`).
Every file is written to a temporary name and renamed into place
(`atomic.py`), the label table last: its presence marks a whole dataset,
so ranks that generate one dataset on a shared root at once are safe."""
from __future__ import annotations

import os

import numpy as np

from .atomic import atomic_write
from .las_io import write_las
from .table import Table


def generate_plot(rng: np.random.Generator, radius: float = 15.0,
                  density: float = 12.0, spatial_signal: bool = False):
    """One plot: returns (points [N,3] float32 local coords, biomass_Mg_ha,
    volume_m3_ha). `density` is points per m² of ground and crown;
    spatial_signal=True mixes two species whose allometry differs ~2x at
    equal height (readable only from local crown geometry)."""
    area = np.pi * radius ** 2
    n_ground = max(50, int(area * density * rng.uniform(0.2, 0.5)))
    r = radius * np.sqrt(rng.random(n_ground))
    th = rng.random(n_ground) * 2 * np.pi
    gx, gy = r * np.cos(th), r * np.sin(th)
    slope = rng.uniform(-0.02, 0.02, size=2)
    gz = gx * slope[0] + gy * slope[1] + rng.normal(0, 0.05, n_ground)
    ground = np.stack([gx, gy, gz], axis=1)

    n_trees = rng.poisson(rng.uniform(2, 40))
    parts = [ground]
    biomass_kg = 0.0
    volume_m3 = 0.0
    for _ in range(n_trees):
        h = rng.gamma(4.0, 4.0)  # tree height, mean ~16 m
        h = float(np.clip(h, 2.0, 38.0))
        conifer = spatial_signal and rng.random() < 0.5
        dbh = 0.012 * h ** 1.3 * rng.uniform(0.8, 1.25)  # diameter (m)
        if spatial_signal:
            crown_r = (np.clip(0.09 * h, 0.4, 2.2) if conifer
                       else np.clip(0.22 * h, 0.8, 6.0))
        else:
            crown_r = np.clip(0.16 * h, 0.6, 4.5)
        tr = (radius - 0.5) * np.sqrt(rng.random())
        tth = rng.random() * 2 * np.pi
        tx, ty = tr * np.cos(tth), tr * np.sin(tth)
        tz = tx * slope[0] + ty * slope[1]
        # airborne lidar sees mostly the upper crown
        n_pts = max(5, int(crown_r ** 2 * np.pi * density
                           * rng.uniform(0.5, 1.5)))
        u = rng.random(n_pts) ** 0.4  # bias toward crown top
        cz = tz + h * (0.35 + 0.65 * (1 - u))
        if spatial_signal and conifer:
            rel_h = (cz - tz) / max(h, 1e-6)
            cone = np.clip(1.2 * (1.0 - rel_h), 0.05, 1.0)
            cr = crown_r * np.sqrt(rng.random(n_pts)) * cone
        else:
            cr = crown_r * np.sqrt(rng.random(n_pts)) * (0.3 + 0.7 * u)
        cth = rng.random(n_pts) * 2 * np.pi
        cx = tx + cr * np.cos(cth)
        cy = ty + cr * np.sin(cth)
        parts.append(np.stack([cx, cy, cz + rng.normal(0, 0.1, n_pts)],
                              axis=1))
        # allometry: stem volume ~ form factor * basal area * height
        v = 0.45 * np.pi * (dbh / 2) ** 2 * h
        if spatial_signal:
            v *= 1.35 if conifer else 0.75
            wood_density = (rng.uniform(560, 640) if conifer
                            else rng.uniform(300, 380))
        else:
            wood_density = rng.uniform(420, 520)
        volume_m3 += v
        biomass_kg += v * wood_density

    pts = np.concatenate(parts, axis=0)
    keep = (pts[:, 0] ** 2 + pts[:, 1] ** 2) <= radius ** 2
    pts = pts[keep]
    area_ha = area / 1e4
    return (pts.astype(np.float32), biomass_kg / 1000.0 / area_ha,
            volume_m3 / area_ha)


def generate_nfi_like_dataset(root: str, n_plots: int = 60, seed: int = 0,
                              radius: float = 15.0,
                              label_format: str = "gpkg",
                              spatial_signal: bool = False) -> str:
    """Create `<root>/raw/` with per-plot .las files and a label table
    (nfi.gpkg, or labels.csv) shaped like the NFI layout: an object-type
    area, pt_identifier column 'las_file', targets BMag_ha / V_ha, no split
    column (the dataset's seed-42 splitter makes one). Returns the label
    file's path. The same seed gives the same files as the JAX package's
    generator."""
    rng = np.random.default_rng(seed)
    raw = os.path.join(root, "raw")
    os.makedirs(os.path.join(raw, "plots"), exist_ok=True)
    rows = []
    for i in range(n_plots):
        pts, bmag, v = generate_plot(rng, radius=radius,
                                     spatial_signal=spatial_signal)
        # place the plot somewhere in a fake projected CRS
        cx, cy = rng.uniform(5e5, 6e5), rng.uniform(6e6, 6.1e6)
        world = pts + np.array([cx, cy, rng.uniform(0, 200)],
                               dtype=np.float32)
        las_name = f"plots/plot_{i:04d}.las"
        low = pts[:, 2] < 0.5
        ground_z = np.median(pts[low, 2]) if low.any() else 0.0
        cls = np.where(np.abs(pts[:, 2] - ground_z) < 0.3, 2, 5)
        with atomic_write(os.path.join(raw, las_name)) as tmp:
            write_las(tmp, world, classification=cls)
        rows.append((f"plot_{i:04d}", cx, cy, bmag, v))
    names = ("las_file", "x", "y", "BMag_ha", "V_ha")
    df = Table({n: [r[j] for r in rows] for j, n in enumerate(names)})
    if label_format == "gpkg":
        from ..visualization.gpkg import write_gpkg
        label_file = os.path.join(raw, "nfi.gpkg")
        with atomic_write(label_file) as tmp:
            write_gpkg(tmp, df, layer="nfi")
    else:
        label_file = os.path.join(raw, "labels.csv")
        with atomic_write(label_file) as tmp:
            df.write_csv(tmp)
    return label_file


def generate_tree(rng: np.random.Generator):
    """One single tree of a treeDB: crown points in local coordinates ->
    (points [N,3] float32, height in m)."""
    h = float(np.clip(rng.gamma(4.0, 4.0), 3.0, 35.0))
    crown_r = np.clip(0.16 * h, 0.6, 4.5)
    n_pts = max(30, int(crown_r ** 2 * np.pi * rng.uniform(8, 25)))
    u = rng.random(n_pts) ** 0.4
    z = h * (0.3 + 0.7 * (1 - u))
    r = crown_r * np.sqrt(rng.random(n_pts)) * (0.3 + 0.7 * u)
    th = rng.random(n_pts) * 2 * np.pi
    pts = np.stack([r * np.cos(th), r * np.sin(th),
                    z + rng.normal(0, 0.1, n_pts)], axis=1)
    return pts.astype(np.float32), h


def generate_tree_db(root: str, n_trees: int = 40, seed: int = 1) -> str:
    """Create a synthetic treeDB at `root` (the layout of
    conf/data/instance/treeDB/ALS.yaml): one .las per tree under raw/ALS/
    and the label table raw/treeDB_epsg_25832.gpkg with file_path, x, y and
    height_m. Returns the label file's path. The same seed gives the same
    files as the JAX package's generator."""
    rng = np.random.default_rng(seed)
    raw = os.path.join(root, "raw")
    os.makedirs(os.path.join(raw, "ALS"), exist_ok=True)
    rows = []
    for i in range(n_trees):
        pts, h = generate_tree(rng)
        cx, cy = rng.uniform(5e5, 6e5), rng.uniform(6e6, 6.1e6)
        world = pts + np.array([cx, cy, rng.uniform(0, 100)], np.float32)
        with atomic_write(os.path.join(raw, f"ALS/tree_{i:04d}.las")) as tmp:
            write_las(tmp, world,
                      classification=np.full(len(pts), 5, np.int32))
        rows.append((f"tree_{i:04d}", cx, cy, h))
    names = ("file_path", "x", "y", "height_m")
    df = Table({n: [r[j] for r in rows] for j, n in enumerate(names)})
    from ..visualization.gpkg import write_gpkg
    label_file = os.path.join(raw, "treeDB_epsg_25832.gpkg")
    with atomic_write(label_file) as tmp:
        write_gpkg(tmp, df, layer="treeDB")
    return label_file
