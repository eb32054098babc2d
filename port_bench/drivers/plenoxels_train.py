"""Plenoxels training on the packed state: ``train/plenoxels_sparse.py::
train_step_tiles_packed_touched_jit`` called as ``cli/train_plenoxels.py::
run``'s loop calls it in ``--step_mode touched`` with the CLI's defaults
(the dense-sweep optimizer under per-visit RMSprop, ``max_touched``, no
occupancy clip), on the trainer the CLI builds after its first upsample
(TV off), steps numbered on from there; each step's batch is the CLI's
draw of coherent tiles from a pool of views, made here on the card.

Set-up makes the grid from the seed and runs the first steps; the
reference follows them. Traffic parameters: ``scene`` (occupancy),
``pool`` (views, size, cameras' radius, the analytic sphere's radius),
``first_steps`` and ``trace_seconds``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench import harness, scenes
from port_bench.reference import plenoxels as ref
from port_bench.work import k3, k4


def _state_unchanged(step):
    def run(trainer, bg, st, *a, **k):
        copy = st._replace(**{f: getattr(st, f).clone() for f in st._fields if getattr(st, f) is not None})
        _, stats = step(trainer, bg, copy, *a, **k)
        return st, stats
    return run


def _half_batch(step):
    def run(trainer, bg, st, rays, target, *a, **k):
        n = rays.origins.shape[0] // 2
        return step(trainer, bg, st, rays.map(lambda x: x[:n]), target[:n], *a, **k)
    return run


FAULTS = {"state_unchanged": _state_unchanged, "half_batch_left_out": _half_batch}
GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


class Cell:
    kind = "train"
    closed = False
    units_per_call = 1
    traced = False

    def __init__(self, spec, seed: int, device, fault=None):
        from nerf_projects_tpu_torch.core.rays import Rays
        from nerf_projects_tpu_torch.ops.brick_grid import BrickGrid
        from nerf_projects_tpu_torch.ops.grid import GridRenderOptions
        from nerf_projects_tpu_torch.ops.kernels import tile_march as tm
        from nerf_projects_tpu_torch.train import PlenoxelsTrainer
        from nerf_projects_tpu_torch.train import plenoxels_sparse as ps

        c, tr = spec.config, spec.traffic
        self.c, self.tm, self.Rays = c, tm, Rays
        self.device = torch.device(device)
        self.seed = seed
        self.reso, self.B = int(c["reso"][0]), int(c["sh_dim"])
        self.radius = float(c["scene_radius"])
        self.tile = tuple(c["tile_shape"])
        self.n_tiles = int(c["batch_size"]) // (self.tile[0] * self.tile[1])
        self.rays_per_unit = self.n_tiles * self.tile[0] * self.tile[1]
        self.step0 = int(c["upsamp_every"])
        sc = tr["scene"]
        active = scenes.shell_bricks(self.reso, sc["r_lo"], sc["r_hi"])
        self.links, coords, self.mask = scenes.brick_geometry(active, self.reso, self.device)
        self.nb = self.mask.shape[0]
        dens, sh = scenes.random_masters(self.mask, self.B, scenes.generator(seed, 30, self.device))
        bg = BrickGrid(brick_links=self.links, density_bricks=dens, sh_bricks=sh, cell_mask=self.mask,
                       brick_coords=coords, reso=(self.reso,) * 3, radius=np.full(3, self.radius, np.float32),
                       center=np.zeros(3, np.float32), basis_dim=self.B)
        # the bf16 copy that K3 and K4 read (the default on the card; asked
        # for, so that the host's plain versions read the same cells)
        self.state = ps.packed_state_from_grid(bg, bf16_cells=True)
        self.geo = tm.geometry_only(bg)
        del dens, sh, bg
        opts = GridRenderOptions(step_size=c["step_size"], sigma_thresh=c["sigma_thresh"],
                                 stop_thresh=c["stop_thresh"], background_brightness=c["background_brightness"])
        # the CLI's make_trainer(tv_on=False) after the first upsample
        self.trainer = PlenoxelsTrainer(
            opts, n_iters=c["lr_decay_steps"], lr_sigma=c["lr_sigma"], lr_sigma_final=c["lr_sigma_final"],
            lr_sigma_delay_steps=c["lr_sigma_delay_steps"], lr_sigma_delay_mult=c["lr_sigma_delay_mult"],
            lr_sh=c["lr_sh"], lr_sh_final=c["lr_sh_final"], lambda_tv=0.0, lambda_tv_sh=0.0,
            lambda_tv_lumisphere=0.0, sigma_optim=c["sigma_optim"], sh_optim=c["sh_optim"], rms_beta=c["rms_beta"],
            rms_pervisit=bool(c["rms_pervisit"]), device=self.device)
        step = ps.train_step_tiles_packed_touched_jit
        if fault is not None:
            step = FAULTS[fault](step)
        self.step_fn = step
        self.dense_optim = bool(c["rms_pervisit"]) or c["sigma_optim"] == "sgd"  # the CLI's auto rule
        self.pool_o, self.pool_d, self.pool_rgb, self.view_shape = self.make_pool(tr["pool"], seed)
        self.draw_gen = scenes.generator(seed, 31, self.device)
        self.tv_gen = scenes.generator(seed, 32, self.device)
        self.step_no = self.step0
        # the first steps, through the window's own call and feed
        self.first = []
        self.first_mse, self.g1, self.change = [], None, None
        for t in range(int(tr["first_steps"])):
            rays, target = self.draw()
            self.first.append((rays.origins, rays.directions, target))
            stats = self._step(rays, target)
            self.first_mse.append(stats["mse"])
            if t == 0:  # per-visit RMSprop's first visit sets rms = g^2
                self.g1 = self._channel_norms(self.state.rms[: self.nb])
        self.change = self._change_norms()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- inputs ------------------------------------------------------------

    def make_pool(self, pool: dict, seed: int):
        H, W = int(pool["height"]), int(pool["width"])
        focal = 0.5 * W / math.tan(0.5 * pool["camera_angle_x"])
        thetas, phis = scenes.view_angles(int(pool["views"]), scenes.sub_seed(seed, 33))
        os_, ds, rgbs = [], [], []
        for th, ph in zip(thetas, phis):
            c2w = scenes.pose_spherical(th, ph, pool["radius"]) @ GL_TO_CV
            o, d = scenes.opencv_rays(H, W, focal, c2w, self.device)
            os_.append(o)
            ds.append(d)
            rgbs.append(scenes.sphere_colors(o, d, pool["sphere_radius"]))
        return torch.cat(os_), torch.cat(ds), torch.cat(rgbs), (len(thetas), H, W)

    def draw(self):
        """The CLI's draw_tiles: n_tiles tiles of th x tw pixels, each at a
        random view and offset, drawn on the card."""
        V, H, W = self.view_shape
        th, tw = self.tile
        g, n = self.draw_gen, self.n_tiles
        v = torch.randint(0, V, (n,), generator=g, device=self.device)
        y0 = torch.randint(0, H - th + 1, (n,), generator=g, device=self.device)
        x0 = torch.randint(0, W - tw + 1, (n,), generator=g, device=self.device)
        dy, dx = torch.meshgrid(torch.arange(th, device=self.device), torch.arange(tw, device=self.device),
                                indexing="ij")
        flat = v[:, None] * (H * W) + (y0[:, None] + dy.reshape(-1)[None]) * W + (x0[:, None] + dx.reshape(-1)[None])
        d = self.pool_d[flat]
        return self.Rays(self.pool_o[flat], d, d), self.pool_rgb[flat]

    def _step(self, rays, target):
        self.step_no += 1
        self.state, stats = self.step_fn(self.trainer, self.geo, self.state, rays, target, self.step_no,
                                         self.tv_gen, max_touched=int(self.c["max_touched"]), use_occupancy=False,
                                         flat_windows=None, dense_optim=self.dense_optim)
        return stats

    def _channel_norms(self, x: torch.Tensor) -> dict:
        """sqrt of the sum over cells of x [nb, 512, CP] by live channel."""
        s = x[..., : 1 + 3 * self.B].double().sum(dim=(0, 1)).clamp(min=0).sqrt()
        return {f"ch{i}": v for i, v in enumerate(s)}

    def _initial_masters(self):
        dens, sh = scenes.random_masters(self.mask, self.B, scenes.generator(self.seed, 30, self.device))
        return dens, sh

    def _change_norms(self) -> dict:
        dens, sh = self._initial_masters()
        pk = self.state.packed_k[: self.nb]
        sq = torch.cat([((pk[..., :1] - dens[..., None]) ** 2).double().sum(dim=(0, 1)),
                        ((pk[..., 1:1 + 3 * self.B] - sh) ** 2).double().sum(dim=(0, 1))])
        return {f"ch{i}": v for i, v in enumerate(sq.sqrt())}

    # -- the window --------------------------------------------------------

    def issue(self, i: int):
        rays, target = self.draw()
        if self.traced and i == 0:
            cells = self.state.cells if self.state.cells is not None else self.state.packed_k.to(torch.bfloat16)
            self.traced_first = (rays.origins, rays.directions, cells[: self.nb].clone())
        self._step(rays, target)

    def after(self, i: int):
        pass

    def launches(self) -> dict:
        return {"tile_march_fwd": self.tm.tile_march_fwd.launches, "tile_march_bwd": self.tm.tile_march_bwd.launches}

    def zero_launches(self):
        self.tm.tile_march_fwd.launches = self.tm.tile_march_bwd.launches = 0

    # -- after the window ----------------------------------------------------

    def trace_context(self, window, trace, pk: dict) -> dict:
        """K4's bound and time on the window's first step (its cells kept
        before it: the work depends on them), and the step's bound (K3's
        march to each ray's exit, K4, and the optimizer's sweep reading and
        writing the state once) over the traced window's steps."""
        o, d, cells = self.traced_first
        T, r = self.n_tiles, self.tile[0] * self.tile[1]
        o, d = o.reshape(T, r, 3), d.reshape(T, r, 3)
        n_steps = ref.max_steps(self.reso, self.c["step_size"])
        pack, _ = ref.pack_tiles(o, d, self.reso, self.radius, self.c["step_size"])
        reach = ref.reachable(self.links, self.reso)
        kw = dict(reach=reach, sigma_thresh=self.c["sigma_thresh"], stop_thresh=self.c["stop_thresh"])
        counts = {}
        for stop in (False, True):
            touched = torch.zeros(self.nb + 1, dtype=torch.bool, device=self.device)
            c = ref.march_counts(cells, self.links, self.reso, pack, n_steps, early_stop=stop, touched=touched, **kw)
            c["touched"] = int(touched[:-1].sum())
            counts[stop] = c
        f3, b3 = k3.work(counts[False], self.B, T * r, T)
        f4, b4 = k4.work(counts[True], self.B, T * r, T)
        live = self.nb * 512 * (1 + 3 * self.B)
        sweep_bytes = live * (4 + 4 + 4 + 4 + 2)  # masters and rms read and written, the bf16 cells written
        step_bound = max((f3 + f4) / pk["fp32_flops_s"], (b3 + b4 + sweep_bytes) / pk["hbm_bytes_s"])
        k4_times = trace.op_durations(k4.NAMES)
        ctx = {"kernels": {}, "model": {"bound_s": window.units * step_bound, "time_s": trace.window_s}}
        if k4_times:
            ctx["kernels"]["k4"] = {"bound_s": max(f4 / pk[k4.PEAK], b4 / pk["hbm_bytes_s"]), "time_s": k4_times[0]}
        return ctx

    def release(self):
        self.first_mse = [float(x) for x in self.first_mse]
        self.g1 = {k: float(v) for k, v in self.g1.items()}
        self.change = {k: float(v) for k, v in self.change.items()}
        self.state = self.trainer = self.geo = self.traced_first = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, dtype) -> tuple:
        """The reference over the first steps: (MSEs, the first gradient's
        norms, the change's norms) by channel."""
        c = self.c
        dens, sh = self._initial_masters()
        masters = torch.cat([dens[..., None], sh], dim=-1)  # [nb, 512, 1 + 3B]
        del dens, sh
        rms = torch.zeros_like(masters)
        start = masters.clone()
        lr_sigma = ref.log_linear(c["lr_sigma"], c["lr_sigma_final"], c["lr_decay_steps"], c["lr_sigma_delay_steps"],
                                  c["lr_sigma_delay_mult"])
        lr_sh = ref.log_linear(c["lr_sh"], c["lr_sh_final"], c["lr_decay_steps"])
        T, r = self.n_tiles, self.tile[0] * self.tile[1]
        n_steps = ref.max_steps(self.reso, c["step_size"])
        kw = dict(sigma_thresh=c["sigma_thresh"], stop_thresh=c["stop_thresh"], dtype=dtype)
        mses, g1 = [], None
        m = self.mask.float()[..., None]
        for t, (o, d, target) in enumerate(self.first):
            o, d, target = o.reshape(T, r, 3), d.reshape(T, r, 3), target.reshape(T, r, 3)
            cells = masters.to(torch.bfloat16)
            pack, vmean = ref.pack_tiles(o, d, self.reso, self.radius, c["step_size"])
            basis = ref.sh_basis(self.B, vmean)
            rgb, acc, _ = ref.march(cells, self.links, self.reso, pack, basis, n_steps, **kw)
            rgb = rgb + (1.0 - acc[..., None]) * c["background_brightness"]
            mses.append(float(torch.mean((rgb - target) ** 2)))
            g, s_total = ref.loss_seeds(rgb, target)
            gd, gsh = ref.march_grads(cells, self.links, self.reso, pack, basis, g, s_total, n_steps, **kw)
            grad = torch.cat([gd[..., None], gsh], dim=-1) * m
            del gd, gsh
            if t == 0:
                g1 = {f"ch{i}": float(v) for i, v in enumerate((grad.double() ** 2).sum(dim=(0, 1)).sqrt())}
            step = self.step0 + 1 + t
            lr = torch.full((1 + 3 * self.B,), lr_sh(step), device=self.device)
            lr[0] = lr_sigma(step)
            masters, rms = ref.rmsprop_pervisit(masters, grad, rms, lr, c["rms_beta"])
            del grad
        change = {f"ch{i}": float(v) for i, v in enumerate(((masters - start).double() ** 2).sum(dim=(0, 1)).sqrt())}
        return mses, g1, change

    def check(self, control: bool = False) -> dict:
        """Each first step's MSE, the first gradient's norm by channel and
        the masters' change by channel after the first steps, the program's
        against the reference's (float32 arithmetic over bfloat16 cells);
        with ``control``, the reference with bfloat16 arithmetic in the
        program's place."""
        mses, g1, change = self.reference_steps(torch.float32)
        if control:
            got_m, got_g, got_c = self.reference_steps(torch.bfloat16)
        else:
            got_m, got_g, got_c = self.first_mse, self.g1, self.change
        med = float(np.median(list(g1.values())))
        still = [k for k, v in g1.items() if v < 1e-3 * med]
        return {
            "mse_gap": max(abs(a - b) / b for a, b in zip(got_m, mses)),
            "grad_norm_gap": harness.leaf_gap(got_g, g1),
            "update_norm_gap": harness.leaf_gap(got_c, change, skip=still),
        }
