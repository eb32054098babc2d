"""NeRF training on the fused train level: ``NeRFTrainer.scan_steps`` with
``use_fused_mlp=True, use_mega=True`` (K2 a level), each step drawing its
batch of rays on the card from a pool of views, the calls dispatched
ahead (at most two in flight).

Set-up makes the trainer, its models from the seed and the pool, then
runs the first steps through ``scan_steps`` one step a call: the
reference follows them. Traffic parameters: ``pool`` (views, size, the
cameras' radius, the analytic sphere's radius), ``steps_per_call`` and
``first_steps``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench import harness, scenes
from port_bench.reference import nerf as ref
from port_bench.work import k1f, k2


def _state_unchanged(trainer):
    trainer.apply_grads = lambda state, grads: state


def _half_batch(trainer):
    step = trainer.train_step

    def half(state, rays, target):
        n = target.shape[0] // 2
        return step(state, rays.map(lambda x: x[:n]), target[:n])
    trainer.train_step = half


FAULTS = {"state_unchanged": _state_unchanged, "half_batch_left_out": _half_batch}


def make_weights(c: dict, seed: int, device) -> dict:
    """The coarse and fine models' float32 parameters by name, from the
    seed on the card, the sigma head set to the configuration's density
    logits (``scenes.set_density_logits``)."""
    shapes = scenes.nerf_shapes(c["netdepth"], c["netwidth"], 3 + 6 * c["multires"], 3 + 6 * c["multires_views"])

    def mlp(p, pts, views, depth):
        with ref.full_fp32():
            return ref.mlp(p, ref.posenc(pts, c["multires"]), ref.posenc(views, c["multires_views"]), depth,
                           torch.float32)

    out = {}
    for k, tag in enumerate(("coarse", "fine")):
        gen = scenes.generator(seed, 20 + k, device)
        p = scenes.nerf_weights(shapes, gen, c["bias_std"], device)
        out[tag] = scenes.set_density_logits(p, mlp, c["netdepth"], gen, c["density_logit_mean"],
                                             c["density_logit_std"])
    return out


class Cell:
    kind = "train"
    closed = False

    def __init__(self, spec, seed: int, device, fault=None):
        from nerf_projects_tpu_torch.core.rays import Rays
        from nerf_projects_tpu_torch.models.pipeline import NeRFRenderConfig
        from nerf_projects_tpu_torch.ops.kernels import fused_train as ft
        from nerf_projects_tpu_torch.train import NeRFTrainer

        c, tr = spec.config, spec.traffic
        self.ft = ft
        self.cfg = c
        self.device = torch.device(device)
        self.batch = int(c["N_rand"])
        self.units_per_call = int(tr["steps_per_call"])
        self.rays_per_unit = self.batch
        rcfg = NeRFRenderConfig(num_coarse_samples=c["N_samples"], num_fine_samples=c["N_importance"],
                                multires=c["multires"], multires_views=c["multires_views"],
                                use_viewdirs=c["use_viewdirs"], white_bkgd=c["white_bkgd"], perturb=c["perturb"] > 0,
                                raw_noise_std=c["raw_noise_std"])
        dtype = getattr(torch, c["compute_dtype"])
        self.trainer = NeRFTrainer(rcfg, depth=c["netdepth"], width=c["netwidth"], near=c["near"], far=c["far"],
                                   lrate=c["lrate"], lrate_decay=c["lrate_decay"], compute_dtype=dtype,
                                   use_fused_mlp=True, use_mega=True, device=self.device)
        if not self.trainer.use_mega:
            raise RuntimeError("the fused train level's gate refused the configuration")
        if fault is not None:
            FAULTS[fault](self.trainer)
        self.draw_seed = scenes.sub_seed(seed, 10) % (2**62)
        state = self.trainer.init_state(self.draw_seed)
        self.weights = make_weights(c, seed, self.device)
        with torch.no_grad():
            for model, tag in zip(state.params, ("coarse", "fine")):
                for name, p in model.named_parameters():
                    p.copy_(self.weights[tag][name])
        self.state = state
        self.pool_rays, self.pool_rgb = self.make_pool(tr["pool"], seed, Rays)
        # the first steps, one a call, through the window's own call and feed
        self.first_losses, self.g1, self.after_first = [], None, None
        for t in range(int(tr["first_steps"])):
            self.state, stats = self.trainer.scan_steps(self.state, self.pool_rays, self.pool_rgb, 1,
                                                         batch_size=self.batch)
            self.first_losses.append(stats["loss"][0])
            if t == 0:
                self.g1 = {f"{tag}.{n}": torch.linalg.norm(self._exp_avg(p) / 0.1)
                           for model, tag in zip(self.state.params, ("coarse", "fine"))
                           for n, p in model.named_parameters()}
        self.after_first = {f"{tag}.{n}": torch.linalg.norm(p.detach() - self.weights[tag][n])
                            for model, tag in zip(self.state.params, ("coarse", "fine"))
                            for n, p in model.named_parameters()}
        # warm the window's call: its shapes are the first steps'
        self.state, _ = self.trainer.scan_steps(self.state, self.pool_rays, self.pool_rgb, self.units_per_call,
                                                batch_size=self.batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- inputs ------------------------------------------------------------

    def make_pool(self, pool: dict, seed: int, Rays):
        """Rays and colours of every pixel of the pool's views, made on the
        card view by view."""
        H, W = int(pool["height"]), int(pool["width"])
        focal = 0.5 * W / math.tan(0.5 * self.cfg["camera_angle_x"])
        thetas, phis = scenes.view_angles(int(pool["views"]), scenes.sub_seed(seed, 11))
        os_, ds, vs, rgbs = [], [], [], []
        for th, ph in zip(thetas, phis):
            o, d, v = scenes.blender_rays(H, W, focal, scenes.pose_spherical(th, ph, pool["radius"]), self.device)
            os_.append(o)
            ds.append(d)
            vs.append(v)
            rgbs.append(scenes.sphere_colors(o, d, pool["sphere_radius"]))
        return Rays(torch.cat(os_), torch.cat(ds), torch.cat(vs)), torch.cat(rgbs)

    def _exp_avg(self, p):
        st = self.state.optimizer.state.get(p, {})
        return st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p)

    # -- the window --------------------------------------------------------

    def issue(self, i: int):
        self.state, _ = self.trainer.scan_steps(self.state, self.pool_rays, self.pool_rgb, self.units_per_call,
                                                batch_size=self.batch)

    def after(self, i: int):
        pass

    def launches(self) -> dict:
        return {"fused_train_level": self.ft.fused_train_level.launches}

    def zero_launches(self):
        self.ft.fused_train_level.launches = 0

    # -- after the window ----------------------------------------------------

    def trace_context(self, window, trace, pk: dict) -> dict:
        """K2's bound over its launches in the traced window (two levels a
        step) and the model's operations of the steps over the window."""
        c = self.cfg
        S0, S1 = c["N_samples"], c["N_samples"] + c["N_importance"]
        fc, bc = k2.work(self.batch, S0, True)
        ff, bf = k2.work(self.batch, S1, False)
        step_bound = (max(fc / pk[k2.PEAK], bc / pk["hbm_bytes_s"])
                      + max(ff / pk[k2.PEAK], bf / pk["hbm_bytes_s"]))
        k2_time = trace.op_seconds(k2.NAMES)
        model_flops = k2.FLOPS_PER_ROW * self.batch * (S0 + S1)
        ctx = {"kernels": {}, "model": {"bound_s": window.units * model_flops / pk[k1f.PEAK],
                                        "time_s": trace.window_s}}
        if k2_time > 0:
            ctx["kernels"]["k2"] = {"bound_s": window.units * step_bound, "time_s": k2_time}
        return ctx

    def release(self):
        """Free the trainer and its state; the pool and the weights stay for
        the reference. The first steps' readings are kept as numbers."""
        self.first_losses = [float(x) for x in self.first_losses]
        self.g1 = {k: float(v) for k, v in self.g1.items()}
        self.after_first = {k: float(v) for k, v in self.after_first.items()}
        self.trainer = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, dtype) -> tuple:
        """The reference over the first steps: (losses, first gradient's
        norms, parameters' change's norms) by leaf."""
        c = self.cfg
        rcfg = {k: c[k] for k in ("multires", "multires_views", "netdepth", "N_samples", "N_importance",
                                  "white_bkgd", "near", "far")}
        params = {tag: {k: v.clone() for k, v in w.items()} for tag, w in self.weights.items()}
        leaves = {f"{t}.{k}": v for t in params for k, v in params[t].items()}
        adam = ref.Adam(leaves, c["lrate"], c["lrate_decay"], c["adam_eps"])
        gen = torch.Generator(device=self.device).manual_seed(self.draw_seed)
        n_pool = self.pool_rgb.shape[0]
        losses, g1 = [], None
        blk = 1024
        for t in range(len(self.first_losses)):
            idx = torch.randint(0, n_pool, (self.batch,), generator=gen, device=self.device)
            u_c = torch.rand((self.batch, c["N_samples"]), generator=gen, device=self.device)
            u_f = torch.rand((self.batch, c["N_importance"]), generator=gen, device=self.device)
            o, d, vd = (x[idx] for x in self.pool_rays)
            target = self.pool_rgb[idx]
            loss, grads = 0.0, None
            for j in range(0, self.batch, blk):
                s = slice(j, j + blk)
                lb, gb = ref.loss_and_grads(params["coarse"], params["fine"], o[s], d[s], vd[s], target[s], u_c[s],
                                            u_f[s], rcfg, dtype)
                w = (min(j + blk, self.batch) - j) / self.batch
                loss += lb * w
                grads = {k: v * w for k, v in gb.items()} if grads is None else \
                    {k: grads[k] + v * w for k, v in gb.items()}
            losses.append(loss)
            if t == 0:
                g1 = {k: float(torch.linalg.norm(v)) for k, v in grads.items()}
            adam.step(leaves, grads)
        change = {f"{t}.{k}": float(torch.linalg.norm(params[t][k] - self.weights[t][k])) for t in params
                  for k in params[t]}
        return losses, g1, change

    def check(self, control: bool = False) -> dict:
        """Each first step's loss, the first gradient's norm by leaf and the
        parameters' change by leaf after the first steps, the program's
        against the reference's (bfloat16 products); with ``control``, the
        reference with float8 (e4m3) products in the program's place."""
        losses, g1, change = self.reference_steps(torch.bfloat16)
        if control:
            got_l, got_g, got_c = self.reference_steps(torch.float8_e4m3fn)
        else:
            got_l, got_g, got_c = self.first_losses, self.g1, self.after_first
        med = float(np.median(list(g1.values())))
        still = [k for k, v in g1.items() if v < 1e-3 * med]
        return {
            "loss_gap": max(abs(a - b) / b for a, b in zip(got_l, losses)),
            "grad_norm_gap": harness.leaf_gap(got_g, g1),
            "update_norm_gap": harness.leaf_gap(got_c, change, skip=still),
        }
