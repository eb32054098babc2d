"""Plenoxels frames: whole views rendered by
``ops/kernels/frame_march.py::render_frame_pallas`` (one K3 launch a
frame, early stop), as the render CLI's ``--frame`` route calls it
(tiles of the traffic's shape, no occupancy clip, the march as long as
the grid's diagonal), one viewer in a closed loop over an orbit of
poses.

Traffic parameters: ``scene`` (the occupancy: ``shell`` with its radii,
or ``sphere``; ``opaque_sigma``, or null for densities U[0, 2]; the
grid's world radius), ``camera`` (the frames' size, focal, the orbit's
radius, the angle between poses, the poses), ``tile``, ``check`` (the
frames and tiles whose answers are compared) and ``count_poses`` (the
poses whose work the traced run counts for the roofline shares).
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import scenes
from port_bench.reference import plenoxels as ref
from port_bench.work import k3


def _alter(out):
    out["rgb"] = out["rgb"] + 1e-3
    return out


def _half(render):
    def run(bg, rays, opts, **kw):
        T = rays.origins.shape[0]
        out = render(bg, rays._replace(origins=rays.origins[: T // 2], directions=rays.directions[: T // 2],
                                       viewdirs=rays.viewdirs[: T // 2]), opts, **kw)
        return {k: torch.cat([v, torch.zeros_like(v)]) if torch.is_tensor(v) and v.dim() and v.shape[0] == T // 2
                else v for k, v in out.items()}
    return run


FAULTS = {
    "answer_altered": lambda render: (lambda *a, **k: _alter(render(*a, **k))),
    "half_batch_left_out": _half,
}


class Cell:
    kind = "frame"
    closed = True
    units_per_call = 1

    def __init__(self, spec, seed: int, device, fault=None):
        from nerf_projects_tpu_torch.core.rays import Rays
        from nerf_projects_tpu_torch.ops.brick_grid import BrickGrid
        from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
        from nerf_projects_tpu_torch.ops.kernels import tile_march as tm
        from nerf_projects_tpu_torch.ops.kernels.frame_march import render_frame_pallas

        cfg, tr = spec.config, spec.traffic
        self.tm = tm
        self.device = torch.device(device)
        self.reso, self.B = int(cfg["reso"][0]), int(cfg["sh_dim"])
        self.step_size = float(cfg["step_size"])
        self.thresh = (float(cfg["sigma_thresh"]), float(cfg["stop_thresh"]))
        self.bkgd = float(cfg["background_brightness"])
        sc, cam = tr["scene"], tr["camera"]
        self.radius = float(sc["grid_radius"])
        if sc["occupancy"] == "shell":
            active = scenes.shell_bricks(self.reso, sc["r_lo"], sc["r_hi"])
        else:
            active = scenes.sphere_bricks(self.reso)
        self.links, coords, mask = scenes.brick_geometry(active, self.reso, self.device)
        self.cells = scenes.random_cells(mask, self.B, scenes.generator(seed, 1, self.device),
                                         opaque_sigma=sc["opaque_sigma"])
        nb = mask.shape[0]
        self.bg = BrickGrid(
            brick_links=self.links, density_bricks=torch.zeros((nb, 1), device=self.device),
            sh_bricks=torch.zeros((nb, 1, 1), device=self.device), cell_mask=mask, brick_coords=coords,
            reso=(self.reso,) * 3, radius=np.full(3, self.radius, np.float32), center=np.zeros(3, np.float32),
            basis_dim=self.B)
        self.opts = GridRenderOptions(step_size=self.step_size, sigma_thresh=self.thresh[0],
                                      stop_thresh=self.thresh[1], background_brightness=self.bkgd)
        self.H, self.W, self.focal = int(cam["height"]), int(cam["width"]), float(cam["focal"])
        self.cam = cam
        self.tile = tuple(tr["tile"])
        self.poses = int(cam["poses"])
        self.frames = []
        for p in range(self.poses):
            o, d = self._rays(p)
            self.frames.append(Rays(o, d, d))
        self.n_tiles = self.frames[0].origins.shape[0]
        self.rays_per_unit = self.H * self.W
        self.count_poses = [int(p) for p in tr.get("count_poses", [])]
        self._plan(tr["check"], seed)
        render = render_frame_pallas
        if fault is not None:
            render = FAULTS[fault](render)
        self.render = render
        self.kept, self.last, self.counts = [], None, {}
        for p in range(min(2, self.poses)):  # every frame has the one shape: warm it
            self.issue(p)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.last = None

    # -- inputs ------------------------------------------------------------

    def _rays(self, pose: int):
        c = self.cam
        o, d = scenes.opencv_rays(self.H, self.W, self.focal, scenes.orbit_pose(pose, c["radius"], c["step_rad"]),
                                  self.device)
        return scenes.to_tiles(o, self.H, self.W, *self.tile), scenes.to_tiles(d, self.H, self.W, *self.tile)

    def _plan(self, check: dict, seed: int):
        """The frames whose answers are kept (the first few, then one drawn
        in each run of ``every``) and, for each, the tiles kept."""
        rng = np.random.default_rng(scenes.sub_seed(seed, 2))
        every, first = int(check["frame_every"]), int(check["first_frames"])
        frames = list(range(first)) + [first + k * every + int(rng.integers(every))
                                       for k in range(int(check["max_frames"]) - first)]
        self.keep = {f: torch.as_tensor(np.sort(rng.choice(self.n_tiles, int(check["tiles_per_frame"]), replace=False)),
                                        device=self.device) for f in frames}

    # -- the window --------------------------------------------------------

    def issue(self, i: int):
        self.last = self.render(self.bg, self.frames[i % self.poses], self.opts, kernel_arrays=self.cells,
                                use_occupancy=False)

    def after(self, i: int):
        if i in self.keep:
            t = self.keep[i]
            self.kept.append((i % self.poses, t, self.last["rgb"][t].clone(), self.last["acc"][t].clone()))
        self.last = None

    def launches(self) -> dict:
        return {"tile_march_fwd": self.tm.tile_march_fwd.launches}

    def zero_launches(self):
        self.tm.tile_march_fwd.launches = 0

    # -- after the window ----------------------------------------------------

    def trace_context(self, window, trace, pk: dict) -> dict:
        """K3's bound and time over the traced frames of the counted poses
        (one K3 launch a frame, in order), and the frames' wall time."""
        n_steps = ref.max_steps(self.reso, self.step_size)
        k3_times = trace.op_durations(k3.NAMES)
        bound = time = wall = 0.0
        for p in self.count_poses:
            if p not in self.counts:
                self.counts[p] = self._count(p, n_steps)
        for f in range(min(len(k3_times), window.units, len(window.latencies))):
            p = f % self.poses
            if p in self.counts:
                flops, nbytes = k3.work(self.counts[p], self.B, self.rays_per_unit, self.n_tiles)
                b = max(flops / pk[k3.PEAK], nbytes / pk["hbm_bytes_s"])
                bound += b
                time += k3_times[f]
                wall += window.latencies[f]
        ctx = {"kernels": {}, "model": None}
        if time > 0:
            ctx["kernels"]["k3"] = {"bound_s": bound, "time_s": time}
            ctx["model"] = {"bound_s": bound, "time_s": wall}
        return ctx

    def _count(self, pose: int, n_steps: int) -> dict:
        """The work of one frame of ``pose`` (``march_counts``, early stop),
        128 tiles at a time."""
        o, d = self._rays(pose)
        touched = torch.zeros(self.cells.shape[0] + 1, dtype=torch.bool, device=self.device)
        reach = ref.reachable(self.links, self.reso)
        c = {}
        for j in range(0, self.n_tiles, 128):
            pack, _ = ref.pack_tiles(o[j:j + 128], d[j:j + 128], self.reso, self.radius, self.step_size)
            cj = ref.march_counts(self.cells, self.links, self.reso, pack, n_steps, early_stop=True, touched=touched,
                                  reach=reach, sigma_thresh=self.thresh[0], stop_thresh=self.thresh[1])
            c = {k: c.get(k, 0) + v for k, v in cj.items()}
        c["touched"] = int(touched[:-1].sum())
        return c

    def release(self):
        """Free the program's state; the inputs (cells, links) stay for the
        reference."""
        self.frames, self.bg, self.last = None, None, None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """The widest gap in rgb and acc between the kept tiles of the
        window's frames and the reference's march of the same tiles; with
        ``control``, the reference in bfloat16 put in the program's
        place."""
        n_steps = ref.max_steps(self.reso, self.step_size)
        worst = 0.0 if self.kept else float("inf")
        for pose, tiles, rgb_p, acc_p in self.kept:
            o, d = self._rays(pose)
            pack, vmean = ref.pack_tiles(o[tiles], d[tiles], self.reso, self.radius, self.step_size)
            basis = ref.sh_basis(self.B, vmean)
            kw = dict(sigma_thresh=self.thresh[0], stop_thresh=self.thresh[1])
            rgb, acc, _ = ref.march(self.cells, self.links, self.reso, pack, basis, n_steps, **kw)
            rgb = rgb + (1.0 - acc[..., None]) * self.bkgd
            if control:
                rgb_p, acc_p, _ = ref.march(self.cells, self.links, self.reso, pack, basis, n_steps,
                                            dtype=torch.bfloat16, **kw)
                rgb_p = rgb_p + (1.0 - acc_p[..., None]) * self.bkgd
            gap = max(float((rgb_p - rgb).abs().max()), float((acc_p - acc).abs().max()))
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
        return {"rgb_acc_gap": worst}
