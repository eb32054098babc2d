"""Fused NeRF train level: MLP forward, volume compositing, the MSE loss
gradient and the MLP weight-gradient backward for one hierarchy level
(port of ``nerf_projects_tpu/ops/pallas/fused_train.py``).

Rows are ray-major (row = ray * S + sample); R rays make one block of
the per-ray inputs ``vt``, padded to 8 rows. The loss convention is the
reference's: L = mean((rgb - target)^2) over the level's rays, with
d_rgb = 2 (rgb - target) / (3 n_rays_total).

``fused_train_level`` launches the CUDA kernel ``csrc/fused_train.cu``
(K2, on the wgmma core ``csrc/mlp_sm90.cuh``) on the flat weight buffers
of ``kernel_weights_sm90`` and ``kernel_weights_sm90_bwd`` and counts its
launches;
``fused_train_level_reference`` is its plain PyTorch version over
``pack_params`` weights, in both input modes. ``train_level`` takes a
``NeRFMLP`` and runs the kernel for tensors on a card and the plain
version for tensors on the CPU; there is no fallback from one to the
other.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from nerf_projects_tpu_torch.models.nerf import NeRFMLP
from nerf_projects_tpu_torch.ops.kernels.fused_mlp import (
    _VP,
    _INT,
    _LL,
    FusedMLPWeights,
    _encode_tile,
    _full_fp32_matmul,
    _fwd_tile,
    check_tensor,
    current_stream,
    kernel_weights_sm90,
    kernel_weights_sm90_bwd,
    load_library,
    mlp_backward_reference,
    pack_params,
    split_grads,
)
from nerf_projects_tpu_torch.ops.posenc import posenc

_EPS = 1e-10
_FLOAT, _CHARP = ctypes.c_float, ctypes.c_char_p


def _check_shapes(x, vt, S, R, raw_inputs):
    n = x.shape[0]
    tile = S * R
    if n % tile:
        raise ValueError(f"N={n} not divisible by tile {tile}")
    if not 1 <= R <= 8:
        raise ValueError(f"R={R} rays per block must be in 1..8")
    cols = 8 if raw_inputs else 32
    want = (n // tile, 8, cols)
    if tuple(vt.shape) != want:
        raise ValueError(f"vt_ray must be {list(want)}, got {list(vt.shape)}")
    xc = 8 if raw_inputs else 64
    if tuple(x.shape) != (n, xc):
        raise ValueError(f"x must be [{n}, {xc}], got {list(x.shape)}")
    return n // S


def fused_train_level_reference(
    W: FusedMLPWeights, x: torch.Tensor, vt: torch.Tensor, *, S: int, R: int,
    n_rays_total: int, bkgd: float, want_weights: bool, raw_inputs: bool = False,
):
    """Plain PyTorch version of the kernel, with its arithmetic term by
    term (reference fused_train.py:142-176) and the bf16 rounding points
    of the fused MLP. x [N, 8] raw points (xyz 0..2, dist*|d| in 3) with
    ``raw_inputs``, else [N, 64] encoded (dist*|d| in 63); vt [T, 8, 8]
    (direction 0..2, target 4..6) or [T, 8, 32] (view encoding 0..26,
    target 28..30). Returns (rgb_out [n_rays, 3], acc [n_rays],
    weights [n_rays, S] or None, padded float32 grads)."""
    n_rays = _check_shapes(x, vt, S, R, raw_inputs)
    per_ray = vt[:, :R].reshape(n_rays, vt.shape[-1]).float()
    if raw_inputs:
        xe = _encode_tile(x, 10, 64)
        dist = x[:, 3].float()
        venc = _encode_tile(per_ray, 4, 32)
        target = per_ray[:, 4:7]
    else:
        xe = x.float()
        dist = x[:, 63].float()
        venc = F.pad(per_ray[:, :27], (0, 5))  # columns 27.. (the target) are masked
        target = per_ray[:, 28:31]
    v = venc.repeat_interleave(S, dim=0)
    with _full_fp32_matmul(x.device):
        rgb_raw, sig_raw, acts = _fwd_tile(W, xe, v)
    rgb_out, acc, w, d_rgb, d_sig = composite_grads(rgb_raw[:, :3], sig_raw[:, 0], dist, target, S=S,
                                                    n_rays_total=n_rays_total, bkgd=bkgd)
    g_rgb = F.pad(d_rgb, (0, 125))
    g_sig = F.pad(d_sig[:, None], (0, 127))
    grads = mlp_backward_reference(xe, W, acts, g_rgb, g_sig)
    return rgb_out, acc, (w if want_weights else None), grads


def composite_grads(rgb_raw: torch.Tensor, logit: torch.Tensor, dist: torch.Tensor, target: torch.Tensor, *,
                    S: int, n_rays_total: int, bkgd: float):
    """The level's compositing and the MSE loss's gradient at the MLP's
    head outputs, term by term as the kernel (reference fused_train.py:
    142-176): rgb_raw [N, 3] and the sigma logit [N] of the ray-major rows,
    dist [N] (dist * |d|), target [N / S, 3] -> (rgb_out [n_rays, 3], acc
    [n_rays], weights [n_rays, S], d_rgb [N, 3], d_sig [N])."""
    n_rays = logit.shape[0] // S
    logit = logit.reshape(n_rays, S)
    dist = dist.reshape(n_rays, S)
    tau = torch.relu(logit) * dist
    e = torch.exp(-tau)
    lterm = torch.log(e + _EPS)
    log_t = F.pad(torch.cumsum(lterm, dim=-1)[:, :-1], (1, 0))  # exclusive prefix
    tr = torch.exp(log_t)
    w = (1.0 - e) * tr
    rgb3 = torch.sigmoid(rgb_raw).reshape(n_rays, S, 3)
    acc = w.sum(-1)
    rgb_out = (w[..., None] * rgb3).sum(-2) + (1.0 - acc[:, None]) * bkgd
    g = 2.0 * (rgb_out - target) / (3.0 * n_rays_total)
    s_row = (g[:, None, :] * (rgb3 - bkgd)).sum(-1)
    ws = w * s_row
    suf = F.pad(torch.flip(torch.cumsum(torch.flip(ws, [-1]), dim=-1), [-1])[:, 1:], (0, 1))  # strict suffix
    r_eps = e / (e + _EPS)
    dtau = tr * e * s_row - r_eps * suf
    d_sig = dtau * dist * (logit > 0.0)
    d_rgb = g[:, None, :] * w[..., None] * rgb3 * (1.0 - rgb3)
    return rgb_out, acc, w, d_rgb.reshape(n_rays * S, 3), d_sig.reshape(n_rays * S)


@functools.lru_cache(maxsize=None)
def _library():
    return load_library("fused_train", {
        "fused_train_level": ([_VP] * 4 + [_LL, _INT, _INT, _INT, _LL, _FLOAT] + [_VP] * 6, _INT),
        "fused_train_weight_elems": ([], _LL),
        "fused_train_weight_t_elems": ([], _LL),
        "fused_train_grad_elems": ([], _LL),
        "fused_train_workspace_bytes": ([_LL], _LL),
        "fused_train_error_string": ([_INT], _CHARP),
    })


def fused_train_level(
    wk: torch.Tensor, wkt: torch.Tensor, x: torch.Tensor, vt: torch.Tensor, *, S: int, R: int,
    n_rays_total: int, bkgd: float, want_weights: bool, raw_inputs: bool = False,
):
    """Launch the CUDA kernel: wk / wkt the ``kernel_weights_sm90`` (with
    ``raw_layout=raw_inputs``) / ``kernel_weights_sm90_bwd`` buffers, x and vt
    as ``fused_train_level_reference`` takes them, float32 on one card.
    Returns what the reference's fused_train_level returns."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_train_level runs on a CUDA device, got {x.device}")
    lib = _library()
    dev = x.device
    n_rays = _check_shapes(x, vt, S, R, raw_inputs)
    n = x.shape[0]
    check_tensor(x, "x", torch.float32, x.shape, dev)
    check_tensor(vt, "vt_ray", torch.float32, vt.shape, dev)
    check_tensor(wk, "weights", torch.bfloat16, (lib.fused_train_weight_elems(),), dev)
    check_tensor(wkt, "weights_bwd", torch.bfloat16, (lib.fused_train_weight_t_elems(),), dev)
    rgb = torch.empty((n_rays, 3), dtype=torch.float32, device=dev)
    acc = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    weights = torch.empty((n_rays, S), dtype=torch.float32, device=dev) if want_weights else None
    grads = torch.empty(lib.fused_train_grad_elems(), dtype=torch.float32, device=dev)
    if n == 0:
        return rgb, acc, weights, split_grads(grads.zero_())
    ws = torch.empty(lib.fused_train_workspace_bytes(n), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fused_train_level(
            x.data_ptr(), vt.data_ptr(), wk.data_ptr(), wkt.data_ptr(), n_rays, S, R,
            int(raw_inputs), n_rays_total, float(bkgd), rgb.data_ptr(), acc.data_ptr(),
            weights.data_ptr() if want_weights else None, grads.data_ptr(), ws.data_ptr(),
            current_stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"fused_train_level launch failed: {lib.fused_train_error_string(rc).decode()}")
    fused_train_level.launches += 1
    return rgb, acc, weights, split_grads(grads)


fused_train_level.launches = 0


def train_level(model: NeRFMLP, x: torch.Tensor, vt: torch.Tensor, *, S: int, R: int,
                n_rays_total: int, bkgd: float, want_weights: bool, raw_inputs: bool = False):
    """One train level of the 8x256 viewdirs ``model``: the kernel for
    tensors on a card, the plain version for tensors on the CPU."""
    kw = dict(S=S, R=R, n_rays_total=n_rays_total, bkgd=bkgd, want_weights=want_weights,
              raw_inputs=raw_inputs)
    if x.device.type == "cuda":
        return fused_train_level(kernel_weights_sm90(model, raw_layout=raw_inputs),
                                 kernel_weights_sm90_bwd(model), x.contiguous(), vt.contiguous(), **kw)
    return fused_train_level_reference(pack_params(model, raw_layout=raw_inputs), x, vt, **kw)


def _dists(z_vals: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    d = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.full_like(z_vals[:, :1], 1e10)], dim=1)
    return d * torch.linalg.norm(dirs, dim=-1, keepdim=True)


def _per_ray_blocks(vt: torch.Tensor, R: int) -> torch.Tensor:
    """[n_rays, C] -> [n_rays / R, 8, C], rays R.. of each block zero."""
    vt = vt.reshape(-1, R, vt.shape[-1])
    return F.pad(vt, (0, 0, 0, 8 - R)) if R < 8 else vt


def pack_level_inputs(pts, viewdirs, z_vals, dirs, target, S, R, multires=10, multires_views=4):
    """Encoded inputs: pts [n_rays, S, 3]; viewdirs, dirs, target
    [n_rays, 3]; z_vals [n_rays, S] -> (x_enc [N, 64] with dist*|d| in
    column 63, vt [n_rays / R, 8, 32]: view encoding 0..26, target
    28..30)."""
    n_rays = pts.shape[0]
    x_enc = posenc(pts.reshape(-1, 3), multires)
    x_enc = torch.cat([
        x_enc, x_enc.new_zeros((x_enc.shape[0], 64 - x_enc.shape[1] - 1)),
        _dists(z_vals, dirs).reshape(-1, 1),
    ], dim=1)
    v_enc = posenc(viewdirs, multires_views)
    vt = torch.zeros((n_rays, 32), dtype=torch.float32, device=pts.device)
    vt[:, : v_enc.shape[1]] = v_enc
    vt[:, 28:31] = target
    return x_enc, _per_ray_blocks(vt, R)


def pack_level_inputs_raw(pts, viewdirs, z_vals, dirs, target, S, R):
    """Raw inputs, encoded in the kernel (weights packed with
    ``raw_layout=True``) -> (x_raw [N, 8]: xyz 0..2, dist*|d| 3;
    vt [n_rays / R, 8, 8]: viewdir 0..2, target 4..6)."""
    n_rays = pts.shape[0]
    x_raw = torch.cat([
        pts.reshape(-1, 3), _dists(z_vals, dirs).reshape(-1, 1),
        pts.new_zeros((n_rays * S, 4)),
    ], dim=1)
    vt = torch.zeros((n_rays, 8), dtype=torch.float32, device=pts.device)
    vt[:, :3] = viewdirs
    vt[:, 4:7] = target
    return x_raw, _per_ray_blocks(vt, R)
