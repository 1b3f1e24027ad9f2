"""Deterministic synthetic nuScenes-like scene generator.

The port's own copy of ``radar_depth_tpu/data/synthetic.py``: the same seed
gives the same arrays in both packages (tests/test_torch_preprocess.py). It
fabricates physically-consistent driving scenes that exercise every
preprocessing path the reference has (upstream:scripts/* generation; SURVEY.md
§3.3): a camera with nuScenes-like intrinsics, an ego vehicle moving through a
world of boxes ("cars"/"walls") over a ground plane, LiDAR-style rays giving
dense-ish GT depth, and radar returns with radar-realistic pathologies —
no elevation resolution (points near sensor height), range noise, and
multipath outliers — delivered as multiple sweeps in per-sweep sensor frames
with full ego-pose/calibration SE(3) chains, exactly like the devkit would.

Pure numpy, fully seeded: sample i of a given config is identical across runs
and machines, making golden-file tests and benchmarks reproducible.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from radar_depth_tpu_torch.data import schema
from radar_depth_tpu_torch.data.schema import Sample, SampleSpec


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Knobs for the simulated world."""

    num_objects: int = 12
    depth_range: tuple = (4.0, 70.0)
    lateral_range: tuple = (-25.0, 25.0)
    object_size_range: tuple = (1.5, 6.0)  # width/height of boxes (m)
    ego_speed_mps: float = 8.0  # forward motion between sweeps
    sweep_dt: float = 0.075  # nuScenes radar ≈ 13 Hz
    radar_height_sigma: float = 0.4  # radar elevation uncertainty (m)
    radar_range_sigma: float = 0.15
    radar_outlier_frac: float = 0.12  # uniform clutter fraction
    # Radar pathologies at nuScenes-like severity (VERDICT r2 #2 — the
    # two-stage filter exists to remove exactly these; with only benign
    # uniform clutter it had nothing to earn its keep on):
    # * azimuth smearing: automotive radar azimuth resolution is degrees —
    #   returns land laterally displaced, often onto the WRONG object or
    #   background, with error growing with range (r·sin σ_az).
    radar_azim_sigma: float = 0.035  # rad (~2°)
    # * multipath ghosts: double/triple-bounce returns at k× the true range
    #   along the same bearing — project onto the object but report far
    #   depth. The paper's central failure mode (SURVEY.md §3.4).
    radar_multipath_frac: float = 0.25  # fraction of true returns ghosted
    radar_ghost_range: tuple = (1.5, 2.4)  # ghost at r·U(range)
    # * object-correlated clutter: under-vehicle/behind-object returns at
    #   z ∈ (z_obj, z_obj + spread) concentrated around object bearings.
    radar_clutter_per_object: float = 1.5  # Poisson mean per object
    radar_clutter_spread: float = 12.0  # m beyond the object
    # * per-sweep miscalibration: ego-compensation error the STORED
    #   transform does not know about, growing with sweep age — older
    #   sweeps reproject with systematic lateral/longitudinal offsets.
    sweep_miscal_yaw: float = 0.0025  # rad per sweep step
    sweep_miscal_trans: float = 0.05  # m per sweep step
    lidar_rows: int = 64
    lidar_cols: int = 640
    camera_height: float = 1.5  # camera above ground (m)
    # Fraction of night scenes (nuScenes scene descriptions carry day/night;
    # the paper reports the splits separately — SURVEY.md §6). Night samples
    # get a darkened render + higher sensor noise; radar/LiDAR are unaffected
    # (radar is lighting-invariant — the paper's motivation).
    night_frac: float = 0.25
    # Night severity 0..1 (r3-s3 NOTES "night-split" row): at 0 the mild
    # model (0.22x brightness + σ=6 noise) leaves the image branch enough
    # signal that two-stage refinement never beats its coarse branch, even
    # on night frames. Severity > 0 DESTROYS information the way real night
    # does — deeper underexposure with shadow crush (clipping to 0 is not
    # invertible by normalization), horizontal motion blur (long exposure),
    # stronger sensor noise — to test whether radar refinement pays once
    # the image genuinely degrades. 0 preserves the r3 datasets bit-exactly.
    night_severity: float = 0.0


def _nuscenes_intrinsics(height: int, width: int) -> np.ndarray:
    """nuScenes CAM_FRONT-like K, scaled from the native 1600×900 (fx≈1266)."""
    scale = width / schema.FULL_WIDTH
    fx = 1266.42 * scale
    fy = fx  # square pixels
    cx = width / 2.0
    cy = height / 2.0
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _se3(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class SyntheticNuScenes:
    """A deterministic map-style dataset of synthetic driving scenes.

    Each sample is generated on demand from ``hash(seed, index)``; no files on
    disk are needed.
    """

    def __init__(
        self,
        num_samples: int,
        spec: SampleSpec | None = None,
        scene: SceneConfig | None = None,
        seed: int = 0,
    ):
        self.num_samples = int(num_samples)
        self.spec = spec or SampleSpec()
        self.scene = scene or SceneConfig()
        self.seed = int(seed)

    def __len__(self) -> int:
        return self.num_samples

    def is_night(self, index: int) -> bool:
        """Deterministic day/night attribute of sample ``index``. Drawn from a
        stream independent of the scene rng so adding the attribute did not
        shift any previously-golden sample content."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(index), 0x4E494748]))
        return bool(rng.uniform() < self.scene.night_frac)

    def sample_tag(self, index: int) -> str:
        """Split tag for per-split evaluation (paper reports day/night
        separately; SURVEY.md §6)."""
        return "night" if self.is_night(index) else "day"

    # ---------------------------------------------------------------- world

    def _make_world(self, rng: np.random.Generator):
        """Boxes: each is (center_x, center_z, half_w, half_h_above_ground,
        albedo rgb). Camera at origin looking +z, y down; ground at
        y = +camera_height."""
        cfg = self.scene
        n = cfg.num_objects
        cx = rng.uniform(*cfg.lateral_range, size=n)
        cz = rng.uniform(*cfg.depth_range, size=n)
        half_w = rng.uniform(cfg.object_size_range[0], cfg.object_size_range[1], n) / 2
        h = rng.uniform(1.0, 3.5, size=n)
        albedo = rng.uniform(0.2, 0.9, size=(n, 3))
        order = np.argsort(cz)  # near-to-far for painter's shading
        return cx[order], cz[order], half_w[order], h[order], albedo[order]

    def _ray_depth(self, dirs: np.ndarray, world) -> np.ndarray:
        """Depth (z of hit point) for unit-z-normalized rays (N, 3) where
        dirs[:, 2] == 1. Intersects ground plane + fronto-parallel boxes,
        returns z-depth; inf where no hit within range."""
        cfg = self.scene
        cx, cz, half_w, h, _ = world
        n_rays = dirs.shape[0]
        depth = np.full(n_rays, np.inf, np.float32)
        # Boxes: plane z = cz_i, extent in x and y.
        for i in range(len(cx)):
            z = cz[i]
            x = dirs[:, 0] * z
            y = dirs[:, 1] * z
            hit = (
                (np.abs(x - cx[i]) <= half_w[i])
                & (y <= cfg.camera_height + 1e-3)
                & (y >= cfg.camera_height - h[i])
            )
            depth = np.where(hit & (z < depth), z, depth)
        # Ground plane y = camera_height (camera frame, y down): y = d*z*dir_y.
        with np.errstate(divide="ignore", invalid="ignore"):
            zg = np.where(dirs[:, 1] > 1e-4, cfg.camera_height / dirs[:, 1], np.inf)
        ground_hit = (zg > 0.5) & (zg < depth)
        depth = np.where(ground_hit, zg, depth)
        return depth

    # -------------------------------------------------------------- renders

    def _render_image(self, K: np.ndarray, world, rng) -> np.ndarray:
        """Flat-shaded render: per-pixel ray cast at low cost (vectorized)."""
        h, w = self.spec.height, self.spec.width
        cfg = self.scene
        cx_, cz_, half_w_, h_, albedo = world
        us, vs = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
        dx = (us - K[0, 2]) / K[0, 0]
        dy = (vs - K[1, 2]) / K[1, 1]
        img = np.zeros((h, w, 3), np.float32)
        depth = np.full((h, w), np.inf, np.float32)
        # sky
        img[..., :] = np.array([0.55, 0.65, 0.85])
        # ground
        with np.errstate(divide="ignore", invalid="ignore"):
            zg = np.where(dy > 1e-4, cfg.camera_height / dy, np.inf)
        gmask = np.isfinite(zg)
        shade = np.clip(1.0 - zg / 120.0, 0.2, 1.0)
        for c, base in enumerate((0.35, 0.33, 0.30)):
            img[..., c] = np.where(gmask, base * shade, img[..., c])
        depth = np.where(gmask, zg, depth)
        # boxes far-to-near (painter)
        for i in range(len(cx_) - 1, -1, -1):
            z = cz_[i]
            x = dx * z
            y = dy * z
            hit = (
                (np.abs(x - cx_[i]) <= half_w_[i])
                & (y <= cfg.camera_height)
                & (y >= cfg.camera_height - h_[i])
                & (z < depth + 1e-6)
            )
            shade = np.clip(1.0 - z / 150.0, 0.3, 1.0)
            for c in range(3):
                img[..., c] = np.where(hit, albedo[i, c] * shade, img[..., c])
            depth = np.where(hit, z, depth)
        img += rng.normal(0, 0.015, img.shape)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def _lidar_points(self, world, rng) -> np.ndarray:
        """LiDAR-style point cloud in camera frame: ray grid over the frustum
        with beam-pattern elevation rows."""
        cfg = self.scene
        elev = np.linspace(-0.12, 0.35, cfg.lidar_rows)  # dy/dz slope (y down)
        azim = np.linspace(-0.62, 0.62, cfg.lidar_cols)  # dx/dz slope
        dx, dy = np.meshgrid(azim, elev)
        dirs = np.stack([dx.ravel(), dy.ravel(), np.ones(dx.size)], axis=-1)
        depth = self._ray_depth(dirs, world)
        valid = np.isfinite(depth) & (depth < self.spec.max_depth * 1.2)
        pts = dirs[valid] * depth[valid, None]
        pts += rng.normal(0, 0.01, pts.shape)  # range noise
        return pts.astype(np.float32)

    def _radar_points_world(self, world, rng) -> np.ndarray:
        """Radar returns in the *reference-time camera frame*: clusters on box
        faces at near-sensor height, degraded by nuScenes-severity pathologies
        (azimuth smearing, multipath ghosts along the bearing, object-
        correlated clutter, uniform clutter). The two-stage filter's job is to
        reject the ghost/clutter population using stage-1 depth (SURVEY.md
        §3.4); see SceneConfig for the knobs."""
        cfg = self.scene
        cx_, cz_, half_w_, h_, _ = world
        pts = []
        for i in range(len(cx_)):
            k = rng.poisson(3)
            if k == 0:
                continue
            x = rng.uniform(cx_[i] - half_w_[i], cx_[i] + half_w_[i], k)
            z = cz_[i] + rng.normal(0, cfg.radar_range_sigma, k)
            # radar has no elevation: report near sensor height w/ big sigma
            y = rng.normal(cfg.camera_height - 0.5, cfg.radar_height_sigma, k)
            pts.append(np.stack([x, y, z], -1))
        if pts:
            pts = np.concatenate(pts, 0)
        else:
            pts = np.zeros((0, 3))

        # azimuth smearing on the true returns: perturb bearing, keep range —
        # lateral error grows ~ r·σ_az, sliding returns off their object
        if len(pts):
            r = np.hypot(pts[:, 0], pts[:, 2])
            az = np.arctan2(pts[:, 0], pts[:, 2])
            az = az + rng.normal(0, cfg.radar_azim_sigma, len(pts))
            pts[:, 0] = r * np.sin(az)
            pts[:, 2] = r * np.cos(az)

        extras = [pts]
        # multipath ghosts: same bearing, k× range (double/triple bounce)
        if len(pts):
            n_mp = int(np.ceil(len(pts) * cfg.radar_multipath_frac))
            sel = rng.choice(len(pts), size=min(n_mp, len(pts)), replace=False)
            src = pts[sel]
            gain = rng.uniform(*cfg.radar_ghost_range, len(src))
            ghosts = src.copy()
            ghosts[:, 0] *= gain
            ghosts[:, 2] *= gain
            ghosts[:, 1] = rng.normal(cfg.camera_height - 0.5,
                                      cfg.radar_height_sigma, len(src))
            extras.append(ghosts)
        # object-correlated clutter: returns just behind/through each object
        # (under-vehicle ground bounce, transmission through gaps)
        occ = []
        for i in range(len(cx_)):
            k = rng.poisson(cfg.radar_clutter_per_object)
            if k == 0:
                continue
            x = rng.uniform(cx_[i] - 1.5 * half_w_[i],
                            cx_[i] + 1.5 * half_w_[i], k)
            z = cz_[i] + rng.uniform(0.5, cfg.radar_clutter_spread, k)
            y = rng.normal(cfg.camera_height - 0.3, 0.5, k)
            occ.append(np.stack([x, y, z], -1))
        if occ:
            extras.append(np.concatenate(occ, 0))
        # uniform clutter
        n_out = int(len(pts) * cfg.radar_outlier_frac) + 2
        extras.append(np.stack(
            [
                rng.uniform(*cfg.lateral_range, n_out),
                rng.normal(cfg.camera_height - 0.5, 0.8, n_out),
                rng.uniform(2.0, cfg.depth_range[1], n_out),
            ],
            -1,
        ))
        return np.concatenate(extras, 0).astype(np.float32)

    # -------------------------------------------------------------- samples

    def __getitem__(self, index: int) -> Sample:
        if not 0 <= index < self.num_samples:
            raise IndexError(index)
        spec, cfg = self.spec, self.scene
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, index, 0x52414452]))
        K = _nuscenes_intrinsics(spec.height, spec.width)
        world = self._make_world(rng)

        image = self._render_image(K, world, rng)
        if self.is_night(index):
            # darken + extra sensor noise; geometry (GT/radar) untouched
            nrng = np.random.default_rng(
                np.random.SeedSequence([self.seed, index, 0x4E494749]))
            s = float(cfg.night_severity)
            dark = image.astype(np.float32) * (0.22 - 0.14 * s)
            if s > 0:
                # long-exposure horizontal motion blur (box filter)
                w = 1 + 2 * int(round(3 * s))
                k = np.ones(w, np.float32) / w
                pad = np.pad(dark, ((0, 0), (w // 2, w // 2), (0, 0)),
                             mode="edge")
                dark = np.stack([
                    np.apply_along_axis(
                        lambda r: np.convolve(r, k, mode="valid"), 1,
                        pad[..., c]) for c in range(dark.shape[-1])], axis=-1)
                # shadow crush: everything below the floor clips to 0 —
                # texture in dark regions is DESTROYED, not just scaled
                dark = np.maximum(dark - 12.0 * s, 0.0)
            dark += nrng.normal(0, 6.0 + 12.0 * s, dark.shape)
            image = np.clip(dark, 0, 255).astype(np.uint8)

        lidar = self._lidar_points(world, rng)
        if len(lidar) > spec.lidar_points:
            # Subsample (not truncate) so the stored buffer is unbiased; the GT
            # map below is built from the *stored* points, keeping the
            # map == rasterize(points) contract exact.
            sel = rng.choice(len(lidar), size=spec.lidar_points, replace=False)
            lidar = lidar[sel]
        lidar_pad, lidar_valid, _ = schema.pad_points(lidar, spec.lidar_points)

        # GT depth map: z-buffer the lidar points (numpy oracle path).
        depth = np.zeros((spec.height, spec.width), np.float32)
        best = np.full((spec.height, spec.width), np.inf, np.float32)
        proj = (K @ lidar.T).T
        uu = np.floor(proj[:, 0] / proj[:, 2]).astype(int)
        vv = np.floor(proj[:, 1] / proj[:, 2]).astype(int)
        zz = lidar[:, 2]
        ok = (
            (uu >= 0) & (uu < spec.width) & (vv >= 0) & (vv < spec.height)
            & (zz > spec.min_depth) & (zz < spec.max_depth)
        )
        for u, v, z in zip(uu[ok], vv[ok], zz[ok]):
            if z < best[v, u]:
                best[v, u] = z
                depth[v, u] = z

        # Radar: world points at reference time → per-sweep sensor frames with
        # a moving ego. Sensor frame = camera translated/rotated slightly, ego
        # moves forward ego_speed*dt per sweep (older sweeps = ego further back).
        radar_world = self._radar_points_world(world, rng)
        s, pr = spec.num_sweeps, spec.radar_points_per_sweep
        sweep_pts = np.zeros((s, pr, 3), np.float32)
        sweep_valid = np.zeros((s, pr), bool)
        sweep_T = np.zeros((s, 4, 4), np.float32)
        # radar mounted 0.3m right, 0.5m below-forward of camera, small yaw
        T_cam_sensor = _se3(_rot_y(0.02), np.array([0.3, 0.3, -0.5], np.float32))
        for j in range(s):
            dz = cfg.ego_speed_mps * cfg.sweep_dt * j  # sweep j is j steps old
            dyaw = rng.normal(0, 0.004)
            # cam_at_ref ← cam_at_sweep: sweep cam was dz *behind* → points
            # seen from sweep pose are dz further away.
            T_ref_from_sweepcam = _se3(_rot_y(dyaw), np.array([0, 0, -dz], np.float32))
            T = T_ref_from_sweepcam @ T_cam_sensor
            sweep_T[j] = T
            # Per-sweep miscalibration (VERDICT r2 #2): points are expressed
            # through the TRUE pose T·E_j, but the sample stores only T — the
            # ego-compensation error E_j (yaw + translation drift growing
            # with sweep age, like real interpolated odometry) reprojects
            # older sweeps with systematic offsets the filter must survive.
            err_yaw = rng.normal(0, cfg.sweep_miscal_yaw * j)
            err_t = rng.normal(0, cfg.sweep_miscal_trans * j, 3).astype(np.float32)
            T_true = T @ _se3(_rot_y(err_yaw), err_t)
            # choose a random subset of world returns per sweep (radar flickers)
            m = min(pr, len(radar_world))
            sel = rng.choice(len(radar_world), size=m, replace=False)
            pts_ref = radar_world[sel]
            # express in sweep sensor frame: p_sensor = inv(T_true) @ p_ref
            Tin = np.linalg.inv(T_true)
            p = (Tin[:3, :3] @ pts_ref.T).T + Tin[:3, 3]
            p += rng.normal(0, 0.02, p.shape)
            sweep_pts[j, :m] = p
            sweep_valid[j, :m] = True

        sample = {
            "image": image,
            "lidar_depth": depth,
            "lidar_points": lidar_pad,
            "lidar_valid": lidar_valid,
            "radar_points": sweep_pts,
            "radar_valid": sweep_valid,
            "radar_transform": sweep_T,
            "intrinsics": K,
        }
        schema.validate_sample(sample, spec)
        return sample

    def batch(self, indices) -> dict:
        return schema.stack_samples([self[i] for i in indices])
