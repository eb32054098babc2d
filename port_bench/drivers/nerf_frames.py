"""NeRF test-view rendering: ``NeRFTrainer.render_image(use_kernel=True)``
(K1f at both levels, the sampling, resampling and compositing in torch)
over whole views of an orbit of poses, in chunks of the configuration's
``chunk`` rays, one viewer in a closed loop.

Traffic parameters: ``orbit`` (poses, elevation, radius: the reference's
render path, nerf/load_blender.py:80-84) and ``check`` (the rays of each
frame whose answers are compared).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench import scenes
from port_bench.drivers.nerf_train import make_weights
from port_bench.reference import nerf as ref
from port_bench.work import k1f


def _alter(render):
    def run(*a, **k):
        out = render(*a, **k)
        out["rgb"] = out["rgb"] + 1e-2
        return out
    return run


def _half(render):
    def run(params, rays, **k):
        h = rays.origins.shape[0] // 2
        out = render(params, rays.map(lambda x: x[:h]), **k)
        return {key: torch.cat([v, torch.zeros_like(v)]) for key, v in out.items()}
    return run


FAULTS = {"answer_altered": _alter, "half_batch_left_out": _half}


class Cell:
    kind = "render"
    closed = True
    units_per_call = 1

    def __init__(self, spec, seed: int, device, fault=None):
        from nerf_projects_tpu_torch.core.rays import Rays
        from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig
        from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm
        from nerf_projects_tpu_torch.train import NeRFTrainer

        c, tr = spec.config, spec.traffic
        self.fm = fm
        self.cfg = c
        self.device = torch.device(device)
        self.chunk = int(c["chunk"])
        rcfg = NeRFRenderConfig(num_coarse_samples=c["N_samples"], num_fine_samples=c["N_importance"],
                                multires=c["multires"], multires_views=c["multires_views"],
                                use_viewdirs=c["use_viewdirs"], white_bkgd=c["white_bkgd"], perturb=False,
                                raw_noise_std=c["raw_noise_std"])
        self.trainer = NeRFTrainer(rcfg, depth=c["netdepth"], width=c["netwidth"], near=c["near"], far=c["far"],
                                   compute_dtype=getattr(torch, c["compute_dtype"]), use_fused_mlp=True,
                                   device=self.device)
        if not self.trainer.use_fused_mlp:
            raise RuntimeError("the fused MLP's gate refused the configuration")
        self.weights = make_weights(c, seed, self.device)
        params = self.trainer.init_params(0)
        with torch.no_grad():
            for model, tag in zip(params, ("coarse", "fine")):
                for name, p in model.named_parameters():
                    p.copy_(self.weights[tag][name])
        self.params = params
        o = tr["orbit"]
        self.H, self.W = int(c["H"]), int(c["W"])
        self.focal = 0.5 * self.W / math.tan(0.5 * c["camera_angle_x"])
        self.thetas = np.linspace(-180.0, 180.0, int(o["poses"]) + 1)[:-1]
        self.orbit = o
        self.frames = [Rays(*self._rays(p)) for p in range(len(self.thetas))]
        self.rays_per_unit = self.H * self.W
        rng = np.random.default_rng(scenes.sub_seed(seed, 3))
        self.n_check = int(tr["check"]["rays_per_frame"])
        self.pick = [torch.as_tensor(np.sort(rng.choice(self.rays_per_unit, self.n_check, replace=False)),
                                     device=self.device) for _ in range(int(tr["check"]["max_frames"]))]
        render = self.trainer.render_image
        if fault is not None:
            render = FAULTS[fault](render)
        self.render = render
        self.kept, self.last = [], None
        self.issue(0)  # every frame has the one shape (the last chunk padded): warm it
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.last = None

    def _rays(self, pose: int):
        return scenes.blender_rays(self.H, self.W, self.focal,
                                   scenes.pose_spherical(self.thetas[pose], self.orbit["phi"], self.orbit["radius"]),
                                   self.device)

    # -- the window --------------------------------------------------------

    def issue(self, i: int):
        self.last = self.render(self.params, self.frames[i % len(self.frames)], chunk=self.chunk, use_kernel=True)

    def after(self, i: int):
        if i < len(self.pick):
            t = self.pick[i]
            self.kept.append((i % len(self.frames), t, self.last["rgb"][t].clone(),
                              self.last["weights"][t, -1].clone()))
        self.last = None

    def launches(self) -> dict:
        return {"fused_mlp_fwd": self.fm.fused_mlp_fwd.launches}

    def zero_launches(self):
        self.fm.fused_mlp_fwd.launches = 0

    # -- after the window ----------------------------------------------------

    def trace_context(self, window, trace, pk: dict) -> dict:
        """K1f's bound over its launches in the traced window (two a chunk,
        the last chunk padded to a whole one) and the model's operations of
        the frames' rays over their wall time."""
        c = self.cfg
        chunks = -(-self.rays_per_unit // self.chunk)
        fc, bc = k1f.work(self.chunk * c["N_samples"])
        ff, bf = k1f.work(self.chunk * (c["N_samples"] + c["N_importance"]))
        frame_bound = chunks * (max(fc / pk[k1f.PEAK], bc / pk["hbm_bytes_s"])
                                + max(ff / pk[k1f.PEAK], bf / pk["hbm_bytes_s"]))
        t = trace.op_seconds(k1f.NAMES)
        model_flops = k1f.FLOPS_PER_ROW * self.rays_per_unit * (2 * c["N_samples"] + c["N_importance"])
        ctx = {"kernels": {}, "model": {"bound_s": window.units * model_flops / pk[k1f.PEAK],
                                        "time_s": sum(window.latencies)}}
        if t > 0:
            ctx["kernels"]["k1f"] = {"bound_s": window.units * frame_bound, "time_s": t}
        return ctx

    def release(self):
        self.trainer = self.params = self.frames = self.last = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """The kept rays of the window's frames against the reference's
        render of the same rays (bfloat16 products): the mean over the rays
        of the widest channel's rgb gap, and the share of rays whose last
        sample is opaque on one side only (the 1e10 tail makes it opaque
        whenever its density is above zero, so a density within rounding
        of zero flips the ray). The widest gap over the rays is not
        compared: a few rays whose fine samples cross a bin of the inverse
        CDF read up to 0.087 in sound runs, and the control's widest gaps
        (from 0.11) are not three times that. With ``control`` the
        reference with float8 (e4m3) products is put in the program's
        place."""
        c = self.cfg
        rcfg = {k: c[k] for k in ("multires", "multires_views", "netdepth", "N_samples", "N_importance",
                                  "white_bkgd", "near", "far")}
        flips, n, total = 0, 0, 0.0
        for pose, t, rgb_p, last_p in self.kept:
            o, d, vd = (x[t] for x in self._rays(pose))
            want = ref.render_rays(self.weights["coarse"], self.weights["fine"], o, d, vd, rcfg, torch.bfloat16)
            if control:
                got = ref.render_rays(self.weights["coarse"], self.weights["fine"], o, d, vd, rcfg,
                                      torch.float8_e4m3fn)
                rgb_p, last_p = got["rgb"], got["last_weight"]
            flip = (last_p > 0) != (want["last_weight"] > 0)
            total += float((rgb_p - want["rgb"]).abs().amax(-1).sum())
            flips += int(flip.sum())
            n += int(flip.numel())
        return {"rgb_gap_mean": total / n if n else float("inf"), "tail_flip_share": flips / n if n else float("inf")}
