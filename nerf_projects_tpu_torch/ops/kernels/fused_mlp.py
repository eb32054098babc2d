"""Fully fused NeRF MLP forward (port of the forward half of
``nerf_projects_tpu/ops/pallas/fused_mlp.py``).

Architecture (models/nerf.py NeRFMLP, use_viewdirs, depth 8, width 256,
skip at 4): trunk_0..7 with the [x, h] concat after trunk_4's relu, the
sigma head, the bottleneck, one 128-wide view layer and the rgb head.
Feature dims are padded as on the TPU: points 63->64, views 27->32,
heads to 128 columns; weights and biases are bf16.

``fused_mlp_fwd`` launches the CUDA kernel ``csrc/fused_mlp_fwd.cu``
(built with nvcc for sm_90a, loaded with ctypes) on the flat weight
buffer of ``kernel_weights`` and counts its launches in
``fused_mlp_fwd.launches``. ``fused_nerf_mlp_reference`` is its plain
PyTorch version over ``pack_params``, with the same bf16 rounding points.
``fused_nerf_mlp`` and ``fused_apply`` take a ``NeRFMLP`` and run the
plain version for tensors on the CPU and the kernel for tensors on a
card; there is no fallback from one to the other.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from nerf_projects_tpu_torch.models.nerf import NeRFMLP
from nerf_projects_tpu_torch.ops.kernels import _build

# live multiply-adds per sample (unpadded widths) and bytes of input and
# output per sample (x [64] and v [32] float32 in, [8] float32 out)
LIVE_MACS_PER_SAMPLE = (
    63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256
    + 256 + 256 * 256 + 283 * 128 + 128 * 3
)
IO_BYTES_PER_SAMPLE = (64 + 32 + 8) * 4


class FusedMLPWeights(NamedTuple):
    """Padded bf16 weights [in, out] and biases [1, out]; names mirror
    models/nerf.py."""

    w0: torch.Tensor    # [64, 256]
    w1: torch.Tensor    # [256, 256]
    w2: torch.Tensor
    w3: torch.Tensor
    w4: torch.Tensor
    w5: torch.Tensor    # [320, 256] (input-first concat)
    w6: torch.Tensor
    w7: torch.Tensor
    wsig: torch.Tensor  # [256, 128] col 0 live
    wb: torch.Tensor    # [256, 256]
    wv: torch.Tensor    # [288, 128]
    wrgb: torch.Tensor  # [128, 128] cols 0..2 live
    b0: torch.Tensor    # [1, 256] ...
    b1: torch.Tensor
    b2: torch.Tensor
    b3: torch.Tensor
    b4: torch.Tensor
    b5: torch.Tensor
    b6: torch.Tensor
    b7: torch.Tensor
    bsig: torch.Tensor  # [1, 128]
    bb: torch.Tensor    # [1, 256]
    bv: torch.Tensor    # [1, 128]
    brgb: torch.Tensor  # [1, 128]


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = x.new_zeros((rows, cols))
    out[: x.shape[0], : x.shape[1]] = x
    return out


def pack_params(model: NeRFMLP, dtype=torch.bfloat16) -> FusedMLPWeights:
    """The port's 8x256 viewdirs ``NeRFMLP`` -> padded kernel weights
    (the layout of the reference's ``pack_params`` with raw_layout=False)."""
    _check_arch(model)

    def kb(layer, rpad, cpad):
        k = layer.weight.detach().T
        b = layer.bias.detach()[None, :]
        return _pad_to(k, rpad, cpad).to(dtype), _pad_to(b, 1, cpad).to(dtype)

    t = model.trunk
    w0, b0 = kb(t[0], 64, 256)
    w1, b1 = kb(t[1], 256, 256)
    w2, b2 = kb(t[2], 256, 256)
    w3, b3 = kb(t[3], 256, 256)
    w4, b4 = kb(t[4], 256, 256)
    # trunk_5 consumes [x(63), h(256)]; padded rows [x(64) | h(256)] = 320
    k5 = t[5].weight.detach().T
    w5 = k5.new_zeros((320, 256))
    w5[:63] = k5[:63]
    w5[64:320] = k5[63:319]
    w5 = w5.to(dtype)
    b5 = _pad_to(t[5].bias.detach()[None, :], 1, 256).to(dtype)
    w6, b6 = kb(t[6], 256, 256)
    w7, b7 = kb(t[7], 256, 256)
    wsig, bsig = kb(model.sigma_head, 256, 128)
    wb, bb = kb(model.bottleneck, 256, 256)
    # view_0 consumes [bottleneck(256), views(27)]; padded to 256 + 32 rows
    kv = model.view_0.weight.detach().T
    wv = kv.new_zeros((288, 128))
    wv[:256] = kv[:256]
    wv[256:283] = kv[256:283]
    wv = wv.to(dtype)
    bv = _pad_to(model.view_0.bias.detach()[None, :], 1, 128).to(dtype)
    wrgb, brgb = kb(model.rgb_head, 128, 128)
    return FusedMLPWeights(
        w0, w1, w2, w3, w4, w5, w6, w7, wsig, wb, wv, wrgb,
        b0, b1, b2, b3, b4, b5, b6, b7, bsig, bb, bv, brgb,
    )


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _full_fp32_matmul(device: torch.device):
    """Float32 matmuls on a card run in full float32, not TF32, inside."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # bf16 operands, float32 accumulation: bf16 products are exact in float32
    return a.to(torch.bfloat16).float() @ w.float()


def fused_nerf_mlp_reference(W: FusedMLPWeights, x: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch version of the kernel: x [N, 64], v [N, 32] float32
    -> [N, 8] float32, columns 0..3 rgb head and 4..7 sigma head (cols
    0..2 and 4 live). Mirrors ``_fwd_tile``: every product rounds its left
    operand to bf16 and accumulates in float32; biases add in float32. On
    a card the matmuls run with TF32 off."""
    with _full_fp32_matmul(x.device):
        h = torch.relu(_mm(x, W.w0) + W.b0.float())
        for w, b in ((W.w1, W.b1), (W.w2, W.b2), (W.w3, W.b3), (W.w4, W.b4)):
            h = torch.relu(_mm(h, w) + b.float())
        cat = torch.cat([x.float(), h], dim=-1)
        h = torch.relu(_mm(cat, W.w5) + W.b5.float())
        h = torch.relu(_mm(h, W.w6) + W.b6.float())
        h = torch.relu(_mm(h, W.w7) + W.b7.float())
        sig = _mm(h, W.wsig) + W.bsig.float()
        bneck = _mm(h, W.wb) + W.bb.float()
        catv = torch.cat([bneck, v.float()], dim=-1)
        hv = torch.relu(_mm(catv, W.wv) + W.bv.float())
        rgb = _mm(hv, W.wrgb) + W.brgb.float()
        return torch.cat([rgb[:, :4], sig[:, :4]], dim=-1)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

# The kernel's weight buffer, in order: (field, rows, cols) of each piece,
# [out][in] as nn.Linear holds it; the heads keep four rows. Offsets must
# match OFF_* in csrc/fused_mlp_fwd.cu.
KERNEL_LAYOUT = (
    ("w0", 256, 64), ("w1", 256, 256), ("w2", 256, 256), ("w3", 256, 256),
    ("w4", 256, 256), ("w5", 256, 320), ("w6", 256, 256), ("w7", 256, 256),
    ("wb", 256, 256), ("wv", 128, 288), ("wsig", 4, 256), ("wrgb", 4, 128),
    ("b0", 1, 256), ("b1", 1, 256), ("b2", 1, 256), ("b3", 1, 256),
    ("b4", 1, 256), ("b5", 1, 256), ("b6", 1, 256), ("b7", 1, 256),
    ("bb", 1, 256), ("bv", 1, 128), ("bsig", 1, 4), ("brgb", 1, 4),
)


def _check_arch(model: NeRFMLP) -> None:
    if not model.use_viewdirs or len(model.trunk) != 8 or model.skips != (4,):
        raise ValueError("the fused MLP covers depth 8 with viewdirs and a skip at 4")


def _build_kernel_weights(model: NeRFMLP) -> torch.Tensor:
    t, sig, bn, v0, rgb = model.trunk, model.sigma_head, model.bottleneck, model.view_0, model.rgb_head
    # each piece: (source [rows, cols] slice, first column in the piece);
    # trunk_5 reads [x(63) | h(256)] and view_0 [bottleneck(256) | views(27)],
    # placed at the kernel's padded columns [x 0..63 | h 64..319] and [.. | 256..287]
    sources = {f"w{i}": ((t[i].weight, 0),) for i in (0, 1, 2, 3, 4, 6, 7)}
    sources.update({f"b{i}": ((t[i].bias[None], 0),) for i in range(8)})
    sources.update(
        w5=((t[5].weight[:, :63], 0), (t[5].weight[:, 63:], 64)),
        wb=((bn.weight, 0),), wv=((v0.weight[:, :256], 0), (v0.weight[:, 256:], 256)),
        wsig=((sig.weight, 0),), wrgb=((rgb.weight, 0),),
        bb=((bn.bias[None], 0),), bv=((v0.bias[None], 0),),
        bsig=((sig.bias[None], 0),), brgb=((rgb.bias[None], 0),),
    )
    total = sum(rows * cols for _, rows, cols in KERNEL_LAYOUT)
    buf = torch.zeros(total, dtype=torch.bfloat16, device=t[0].weight.device)
    at = 0
    for name, rows, cols in KERNEL_LAYOUT:
        piece = buf[at: at + rows * cols].view(rows, cols)
        for src, c0 in sources[name]:
            piece[: src.shape[0], c0: c0 + src.shape[1]] = src.detach()
        at += rows * cols
    return buf


def kernel_weights(model: NeRFMLP) -> torch.Tensor:
    """The kernel's flat bf16 weight buffer (KERNEL_LAYOUT), built from the
    8x256 viewdirs ``NeRFMLP``'s parameters and kept on the model until one
    of them is replaced or changed in place."""
    _check_arch(model)
    key = tuple((p.data_ptr(), p._version) for p in model.parameters())
    cached = model.__dict__.get("_kernel_weights")
    if cached is None or cached[0] != key:
        cached = (key, _build_kernel_weights(model))
        model.__dict__["_kernel_weights"] = cached
    return cached[1]


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("fused_mlp_fwd")
    vp = ctypes.c_void_p
    lib.fused_mlp_fwd.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp]
    lib.fused_mlp_fwd.restype = ctypes.c_int
    lib.fused_mlp_fwd_weight_elems.argtypes = []
    lib.fused_mlp_fwd_weight_elems.restype = ctypes.c_longlong
    lib.fused_mlp_fwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_mlp_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def fused_mlp_fwd(wk: torch.Tensor, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: wk a ``kernel_weights`` buffer, x [N, 64]
    and v [N, 32] float32 on one card -> [N, 8] float32. Any N >= 0."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_fwd runs on a CUDA device, got {x.device}")
    lib = _library()
    n = x.shape[0]
    _check(x, "x", torch.float32, (n, 64), x.device)
    _check(v, "v", torch.float32, (n, 32), x.device)
    _check(wk, "weights", torch.bfloat16, (lib.fused_mlp_fwd_weight_elems(),), x.device)
    out = torch.empty((n, 8), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_mlp_fwd(x.data_ptr(), v.data_ptr(), wk.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_fwd launch failed: {lib.fused_mlp_fwd_error_string(rc).decode()}")
    fused_mlp_fwd.launches += 1
    return out


fused_mlp_fwd.launches = 0


def fused_nerf_mlp(model: NeRFMLP, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x [N, 64] points encoding (63 live), v [N, 32] view encoding (27
    live) -> raw [N, 8]: cols 0..2 rgb logits, col 4 sigma logit. The
    kernel on a card, the plain version on the CPU."""
    if x.device.type == "cuda":
        return fused_mlp_fwd(kernel_weights(model), x.float().contiguous(), v.float().contiguous())
    return fused_nerf_mlp_reference(pack_params(model), x, v)


def _pad_inputs(pts_enc: torch.Tensor, views_enc: torch.Tensor):
    n = pts_enc.shape[0]
    x = pts_enc.new_zeros((n, 64), dtype=torch.float32)
    x[:, :63] = pts_enc
    v = views_enc.new_zeros((n, 32), dtype=torch.float32)
    v[:, :27] = views_enc
    return x, v


def fused_apply(model: NeRFMLP, pts_enc: torch.Tensor, views_enc: torch.Tensor):
    """Drop-in for ``model(pts_enc, views_enc)`` on [N, 63] / [N, 27]
    encodings -> [N, 4] (rgb logits, sigma logit), in bf16 products. No
    row padding: the kernel masks the tail."""
    out = fused_nerf_mlp(model, *_pad_inputs(pts_enc, views_enc))
    return torch.cat([out[:, 0:3], out[:, 4:5]], dim=-1)


def fused_apply_reference(W: FusedMLPWeights, pts_enc: torch.Tensor, views_enc: torch.Tensor):
    """``fused_apply`` through the plain version over ``pack_params``
    weights, on any device."""
    out = fused_nerf_mlp_reference(W, *_pad_inputs(pts_enc, views_enc))
    return torch.cat([out[:, 0:3], out[:, 4:5]], dim=-1)
