"""Fully fused NeRF MLP, forward and weight-gradient backward (port of
``nerf_projects_tpu/ops/pallas/fused_mlp.py``).

Architecture (models/nerf.py NeRFMLP, use_viewdirs, depth 8, width 256,
skip at 4): trunk_0..7 with the [x, h] concat after trunk_4's relu, the
sigma head, the bottleneck, one 128-wide view layer and the rgb head.
Feature dims are padded as on the TPU: points 63->64, views 27->32,
heads to 128 columns; weights and biases are bf16.

Kernels (CUDA C++ for sm_90a under ``csrc/``, built with nvcc and loaded
with ctypes), each with a launch counter and its plain PyTorch version:

- ``fused_mlp_fwd`` (``csrc/fused_mlp_fwd.cu``, K1f) on the wgmma core
  (``csrc/mlp_sm90.cuh``) over ``kernel_weights_sm90(model)``; plain:
  ``fused_nerf_mlp_reference`` over ``pack_params``.
- ``fused_mlp_bwd`` (``csrc/fused_mlp_bwd.cu``, K1b): the 24 padded
  weight gradients from the inputs and the output gradient, recomputing
  the forward, on the wgmma core over ``kernel_weights_sm90(model)`` (K1f's
  buffer) and ``kernel_weights_sm90_bwd(model)``; plain:
  ``fused_mlp_bwd_reference`` over ``mlp_backward_reference``, with the
  same bf16 rounding points.
- ``fused_mlp_raw_fwd`` / ``fused_mlp_raw_bwd`` (``csrc/fused_mlp_raw_fwd.cu``
  and ``fused_mlp_raw_bwd.cu``, K1rf and K1rb): K1f and K1b on raw points
  and view directions [N, 8] (3 live), encoded in the kernel
  (``_encode_tile``: 10 and 4 frequencies, block layout), both on the
  wgmma core over ``kernel_weights_sm90(model, raw_layout=True)``, K1rb's
  dX products over ``kernel_weights_sm90_bwd(model)``; plain:
  ``fused_nerf_mlp_raw_reference`` and ``fused_mlp_raw_bwd_reference``.

``forward_weights`` / ``backward_weights`` say which buffers each route's
kernels take: one forward gather a route, which its backward reuses.

``fused_nerf_mlp`` / ``fused_apply`` (encodings) and ``fused_nerf_mlp_raw``
/ ``fused_apply_raw`` (raw points) take a ``NeRFMLP`` and are
differentiable: an autograd Function runs the kernels on a card and the
plain versions on the CPU (no fallback from one to the other), and maps
the padded gradients back onto the ``nn.Linear`` parameters. The inputs
get no gradient, as on the TPU. ``pack_params`` / ``unpack_grads`` with
``raw_layout=True`` permute the encoded-input rows to the block layout of
the in-kernel encoder (``_encode_tile``) that K1r and the fused train
level use.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from nerf_projects_tpu_torch.models.nerf import NeRFMLP
from nerf_projects_tpu_torch.obs.trace import span
from nerf_projects_tpu_torch.ops.kernels import _build

# live multiply-adds per sample (unpadded widths) and bytes of input and
# output per sample (x [64] and v [32] float32 in, [8] float32 out)
LIVE_MACS_PER_SAMPLE = (
    63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256
    + 256 + 256 * 256 + 283 * 128 + 128 * 3
)
IO_BYTES_PER_SAMPLE = (64 + 32 + 8) * 4
# K1r's: raw points p [8] and view directions v [8] in, [8] out
RAW_IO_BYTES_PER_SAMPLE = (8 + 8 + 8) * 4


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


def _block_perm(n_freqs: int, dims: int = 3) -> list:
    """Row permutation from the block-layout encoding to the interleaved
    one the model's weights expect: perm[j] is the interleaved row that
    feeds block row j."""
    perm = list(range(dims))
    for i in range(n_freqs):  # sin block
        for d in range(dims):
            perm.append(dims + 2 * dims * i + d)
    for i in range(n_freqs):  # cos block
        for d in range(dims):
            perm.append(dims + 2 * dims * i + dims + d)
    return perm


@functools.lru_cache(maxsize=None)
def _perm_index(n_freqs: int, device: torch.device) -> torch.Tensor:
    """``_block_perm(n_freqs)`` as an index tensor on ``device``, made
    once: indexing with a Python list copies it to the card each time."""
    return torch.tensor(_block_perm(n_freqs), device=device)


def _encode_tile(pts: torch.Tensor, n_freqs: int, out_cols: int) -> torch.Tensor:
    """Block-layout positional encoding of [T, >=3] points (3 live) ->
    [T, out_cols]: [x(3), sin(2^f x) f<F, sin(2^f x + pi/2) f<F], zeros
    after; float32, cos taken as sin(x + pi/2) as the in-kernel encoder."""
    p3 = pts[:, :3].float()
    xb = torch.cat([p3 * (2.0 ** i) for i in range(n_freqs)], dim=-1)
    enc = torch.cat([p3, torch.sin(xb), torch.sin(xb + 0.5 * math.pi)], dim=-1)
    return F.pad(enc, (0, out_cols - enc.shape[-1]))


def pack_params(model: NeRFMLP, dtype=torch.bfloat16, raw_layout: bool = False) -> FusedMLPWeights:
    """The port's 8x256 viewdirs ``NeRFMLP`` -> padded kernel weights, as
    the reference's ``pack_params``. ``raw_layout=True`` permutes
    trunk_0's and trunk_5's point rows and view_0's view rows to the
    block layout of ``_encode_tile``."""
    _check_arch(model)
    dev = model.trunk[0].weight.device
    perm_pts = _perm_index(10, dev) if raw_layout else slice(None)
    perm_views = _perm_index(4, dev) if raw_layout else slice(None)

    def kb(layer, rpad, cpad, k=None):
        k = layer.weight.detach().T if k is None else k
        b = layer.bias.detach()[None, :]
        return _pad_to(k, rpad, cpad).to(dtype), _pad_to(b, 1, cpad).to(dtype)

    t = model.trunk
    w0, b0 = kb(t[0], 64, 256, t[0].weight.detach().T[perm_pts])
    w1, b1 = kb(t[1], 256, 256)
    w2, b2 = kb(t[2], 256, 256)
    w3, b3 = kb(t[3], 256, 256)
    w4, b4 = kb(t[4], 256, 256)
    # trunk_5 consumes [x(63), h(256)]; padded rows [x(64) | h(256)] = 320
    k5 = t[5].weight.detach().T
    w5 = k5.new_zeros((320, 256))
    w5[:63] = k5[:63][perm_pts]
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
    wv[256:283] = kv[256:283][perm_views]
    wv = wv.to(dtype)
    bv = _pad_to(model.view_0.bias.detach()[None, :], 1, 128).to(dtype)
    wrgb, brgb = kb(model.rgb_head, 128, 128)
    return FusedMLPWeights(
        w0, w1, w2, w3, w4, w5, w6, w7, wsig, wb, wv, wrgb,
        b0, b1, b2, b3, b4, b5, b6, b7, bsig, bb, bv, brgb,
    )


def unpack_grads(g: FusedMLPWeights, model: NeRFMLP, raw_layout: bool = False) -> dict:
    """Padded weight gradients -> float32 gradients of the model's
    parameters, by name (``nn.Linear`` shapes: weight [out, in]).
    ``raw_layout=True`` undoes ``pack_params(raw_layout=True)``'s row
    permutation."""
    def unperm(rows, n_freqs):
        out = torch.zeros_like(rows)
        out[_perm_index(n_freqs, rows.device)] = rows
        return out

    w0, w5x, wvv = g.w0[:63], g.w5[:63], g.wv[256:283]
    if raw_layout:
        w0, w5x, wvv = unperm(w0, 10), unperm(w5x, 10), unperm(wvv, 4)
    kernels = {
        "trunk.0": w0, "trunk.1": g.w1, "trunk.2": g.w2, "trunk.3": g.w3, "trunk.4": g.w4,
        "trunk.5": torch.cat([w5x, g.w5[64:320]]), "trunk.6": g.w6, "trunk.7": g.w7,
        "sigma_head": g.wsig, "bottleneck": g.wb,
        "view_0": torch.cat([g.wv[:256], wvv]), "rgb_head": g.wrgb,
    }
    biases = {
        "trunk.0": g.b0, "trunk.1": g.b1, "trunk.2": g.b2, "trunk.3": g.b3, "trunk.4": g.b4,
        "trunk.5": g.b5, "trunk.6": g.b6, "trunk.7": g.b7, "sigma_head": g.bsig,
        "bottleneck": g.bb, "view_0": g.bv, "rgb_head": g.brgb,
    }
    out = {}
    for name, p in model.named_parameters():
        layer, kind = name.rsplit(".", 1)
        if kind == "weight":
            o, i = p.shape
            out[name] = kernels[layer][:i, :o].T.float().contiguous()
        else:
            out[name] = biases[layer][0, : p.shape[0]].float().contiguous()
    return out


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


_SUM_DTYPE = torch.float32


@contextlib.contextmanager
def float64_sums():
    """Inside, the plain versions sum their bf16 products in float64 and
    round the sums to float32: the yardstick for how far float32 sums,
    in any order, stray."""
    global _SUM_DTYPE
    old, _SUM_DTYPE = _SUM_DTYPE, torch.float64
    try:
        yield
    finally:
        _SUM_DTYPE = old


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # bf16 operands, float32 accumulation: bf16 products are exact in float32
    return (a.to(torch.bfloat16).to(_SUM_DTYPE) @ w.to(_SUM_DTYPE)).float()


def _fwd_tile(W: FusedMLPWeights, x: torch.Tensor, v: torch.Tensor):
    """The reference's ``_fwd_tile``: (rgb head [N, 128], sigma head
    [N, 128], float32 activations by name)."""
    acts = {}
    h = torch.relu(_mm(x, W.w0) + W.b0.float())
    acts["a0"] = h
    for i, (w, b) in enumerate(((W.w1, W.b1), (W.w2, W.b2), (W.w3, W.b3), (W.w4, W.b4)), start=1):
        h = torch.relu(_mm(h, w) + b.float())
        acts[f"a{i}"] = h
    cat = torch.cat([x.float(), h], dim=-1)
    acts["cat"] = cat
    h = torch.relu(_mm(cat, W.w5) + W.b5.float())
    acts["a5"] = h
    h = torch.relu(_mm(h, W.w6) + W.b6.float())
    acts["a6"] = h
    h = torch.relu(_mm(h, W.w7) + W.b7.float())
    acts["a7"] = h
    sig = _mm(h, W.wsig) + W.bsig.float()
    bneck = _mm(h, W.wb) + W.bb.float()
    catv = torch.cat([bneck, v.float()], dim=-1)
    acts["catv"] = catv
    hv = torch.relu(_mm(catv, W.wv) + W.bv.float())
    acts["hv"] = hv
    rgb = _mm(hv, W.wrgb) + W.brgb.float()
    return rgb, sig, acts


def fused_nerf_mlp_reference(W: FusedMLPWeights, x: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch version of the forward kernel: x [N, 64], v [N, 32]
    float32 -> [N, 8] float32, columns 0..3 rgb head and 4..7 sigma head
    (cols 0..2 and 4 live). Mirrors ``_fwd_tile``: every product rounds
    its left operand to bf16 and accumulates in float32; biases add in
    float32. On a card the matmuls run with TF32 off."""
    with _full_fp32_matmul(x.device):
        rgb, sig, _ = _fwd_tile(W, x, v)
        return torch.cat([rgb[:, :4], sig[:, :4]], dim=-1)


def _mmT(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # a [T, I]^T @ b [T, O] -> [I, O]: both operands bf16, float32 sums
    return (a.to(torch.bfloat16).to(_SUM_DTYPE).T @ b.to(torch.bfloat16).to(_SUM_DTYPE)).float()


def _mmBT(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # g [T, O] @ w^T [O, I] -> [T, I]: g rounded to bf16, float32 sums
    return (g.to(torch.bfloat16).to(_SUM_DTYPE) @ w.to(_SUM_DTYPE).T).float()


def mlp_backward_reference(x, W: FusedMLPWeights, acts: dict, g_rgb, g_sig) -> FusedMLPWeights:
    """Plain version of the reference's ``_mlp_backward``: the padded
    float32 weight and bias gradients from the heads' output gradients
    g_rgb / g_sig [T, 128] (live columns 0..3) over the forward's
    activations. ``mmT`` rounds both operands to bf16, ``mmBT`` rounds g;
    relu masks come from a float32 ``> 0``; bias gradients are float32
    sums."""
    def pos(a):
        return (a.float() > 0).float()

    with _full_fp32_matmul(x.device):
        gr = {}
        gr["wrgb"] = _mmT(acts["hv"], g_rgb)
        gr["brgb"] = g_rgb.sum(0, keepdim=True)
        g_hv = _mmBT(g_rgb, W.wrgb) * pos(acts["hv"])
        gr["wv"] = _mmT(acts["catv"], g_hv)
        gr["bv"] = g_hv.sum(0, keepdim=True)
        g_bneck = _mmBT(g_hv, W.wv)[:, :256]
        gr["wb"] = _mmT(acts["a7"], g_bneck)
        gr["bb"] = g_bneck.sum(0, keepdim=True)
        gr["wsig"] = _mmT(acts["a7"], g_sig)
        gr["bsig"] = g_sig.sum(0, keepdim=True)
        g_h = (_mmBT(g_bneck, W.wb) + _mmBT(g_sig, W.wsig)) * pos(acts["a7"])
        gr["w7"] = _mmT(acts["a6"], g_h)
        gr["b7"] = g_h.sum(0, keepdim=True)
        g_h = _mmBT(g_h, W.w7) * pos(acts["a6"])
        gr["w6"] = _mmT(acts["a5"], g_h)
        gr["b6"] = g_h.sum(0, keepdim=True)
        g_h = _mmBT(g_h, W.w6) * pos(acts["a5"])
        gr["w5"] = _mmT(acts["cat"], g_h)
        gr["b5"] = g_h.sum(0, keepdim=True)
        g_h = _mmBT(g_h, W.w5)[:, 64:320] * pos(acts["a4"])
        for i in (4, 3, 2, 1):
            w = getattr(W, f"w{i}")
            gr[f"w{i}"] = _mmT(acts[f"a{i - 1}"], g_h)
            gr[f"b{i}"] = g_h.sum(0, keepdim=True)
            g_h = _mmBT(g_h, w) * pos(acts[f"a{i - 1}"])
        gr["w0"] = _mmT(x.float(), g_h)
        gr["b0"] = g_h.sum(0, keepdim=True)
        return FusedMLPWeights(**gr)


def _head_grads(g8: torch.Tensor):
    """g8 [N, 8] (cols 0..3 rgb head, 4..7 sigma head) -> g_rgb, g_sig [N, 128]."""
    g8 = g8.float()
    return F.pad(g8[:, :4], (0, 124)), F.pad(g8[:, 4:8], (0, 124))


def fused_mlp_bwd_reference(W: FusedMLPWeights, x: torch.Tensor, v: torch.Tensor,
                            g: torch.Tensor) -> FusedMLPWeights:
    """Plain version of the backward kernel: x [N, 64], v [N, 32] and the
    output gradient g [N, 8] -> the padded float32 gradients of ``W``,
    recomputing the forward as the reference's ``_bwd_body`` does."""
    with _full_fp32_matmul(x.device):
        _, _, acts = _fwd_tile(W, x, v)
    return mlp_backward_reference(x, W, acts, *_head_grads(g))


def _encode_raw(p: torch.Tensor, v: torch.Tensor):
    """Raw points and view directions [N, >=3] -> the encodings K1r makes
    in the kernel: x [N, 64] (10 frequencies), v [N, 32] (4)."""
    return _encode_tile(p, 10, 64), _encode_tile(v, 4, 32)


def fused_nerf_mlp_raw_reference(W: FusedMLPWeights, p: torch.Tensor, v: torch.Tensor):
    """Plain version of K1rf: p, v [N, 8] float32 raw points and view
    directions (columns 0..2 live) -> [N, 8], as ``fused_nerf_mlp_reference``
    on the block encodings of ``_encode_tile``; ``W`` from
    ``pack_params(model, raw_layout=True)``."""
    return fused_nerf_mlp_reference(W, *_encode_raw(p, v))


def fused_mlp_raw_bwd_reference(W: FusedMLPWeights, p: torch.Tensor, v: torch.Tensor,
                                g: torch.Tensor) -> FusedMLPWeights:
    """Plain version of K1rb: the padded float32 gradients of the
    raw-layout ``W`` from raw p, v [N, 8] and the output gradient g [N, 8].
    The encodings are recomputed, as the reference's ``_bwd_raw_kernel``
    does, and dW0 = mmT(x, g) rounds them to bf16."""
    return fused_mlp_bwd_reference(W, *_encode_raw(p, v), g)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

# The staging layout the wgmma core's buffers are built from (in float64,
# over the model's parameters): (field, rows, cols) of each piece, [out][in]
# as nn.Linear holds it, the inputs padded as the kernels read them; the
# heads keep four rows.
KERNEL_LAYOUT = (
    ("w0", 256, 64), ("w1", 256, 256), ("w2", 256, 256), ("w3", 256, 256),
    ("w4", 256, 256), ("w5", 256, 320), ("w6", 256, 256), ("w7", 256, 256),
    ("wb", 256, 256), ("wv", 128, 288), ("wsig", 4, 256), ("wrgb", 4, 128),
    ("b0", 1, 256), ("b1", 1, 256), ("b2", 1, 256), ("b3", 1, 256),
    ("b4", 1, 256), ("b5", 1, 256), ("b6", 1, 256), ("b7", 1, 256),
    ("bb", 1, 256), ("bv", 1, 128), ("bsig", 1, 4), ("brgb", 1, 4),
)
# The staging layout of the dX products' matrices, [in][out] (view_0's
# bottleneck rows, trunk_5's h rows).
KERNEL_LAYOUT_BWD = (
    ("wv", 256, 128), ("wb", 256, 256), ("w7", 256, 256), ("w6", 256, 256),
    ("w5", 256, 256), ("w4", 256, 256), ("w3", 256, 256), ("w2", 256, 256),
    ("w1", 256, 256),
)
# FusedMLPWeights' padded shapes: the layout of the kernels' gradient buffer
# (GW* in csrc/mlp_tile.cuh).
GRAD_SHAPES = (
    (64, 256), (256, 256), (256, 256), (256, 256), (256, 256), (320, 256),
    (256, 256), (256, 256), (256, 128), (256, 256), (288, 128), (128, 128),
    (1, 256), (1, 256), (1, 256), (1, 256), (1, 256), (1, 256), (1, 256),
    (1, 256), (1, 128), (1, 256), (1, 128), (1, 128),
)
GRAD_ELEMS = sum(r * c for r, c in GRAD_SHAPES)
# The wgmma core's buffers (csrc/mlp_sm90.cuh, offsets SW_* and SWT_*):
# (field, N, K, KD) of each layer's [N][K] matrix, stored in passes of at
# most 128 rows, each as K-slabs of depth KD (the last may be shallower),
# each slab [KD / 8][rows / 8][8][8]: wgmma's K-major core matrices, ready
# for one bulk copy. The forward's matrices are KERNEL_LAYOUT's [out][in]
# pieces, the heads padded to 8 rows; its biases follow, the heads' padded
# to 8.
SM90_LAYOUT = (
    ("w0", 256, 64, 64), ("w1", 256, 256, 64), ("w2", 256, 256, 64), ("w3", 256, 256, 64),
    ("w4", 256, 256, 64), ("w5", 256, 320, 64), ("w6", 256, 256, 64), ("w7", 256, 256, 64),
    ("wsig", 8, 256, 256), ("wb", 256, 256, 64), ("wv", 128, 288, 64), ("wrgb", 8, 128, 128),
)
SM90_BIASES = (
    ("b0", 256), ("b1", 256), ("b2", 256), ("b3", 256), ("b4", 256), ("b5", 256), ("b6", 256),
    ("b7", 256), ("bb", 256), ("bv", 128), ("bsig", 8), ("brgb", 8),
)
# The dX products' matrices [N = in][K = out]: the rgb head's transpose
# (K padded to 16), KERNEL_LAYOUT_BWD's view_0 and bottleneck pieces, the
# latter with the sigma head's transpose appended as 16 more K columns
# (trunk_7's gradient takes both), then w7, w6, w5's h rows, w4..w1.
SM90_LAYOUT_BWD = (
    ("wrgb", 128, 16, 16), ("wv", 256, 128, 64), ("wb", 256, 272, 64), ("w7", 256, 256, 64),
    ("w6", 256, 256, 64), ("w5", 256, 256, 64), ("w4", 256, 256, 64), ("w3", 256, 256, 64),
    ("w2", 256, 256, 64), ("w1", 256, 256, 64),
)


def _check_arch(model: NeRFMLP) -> None:
    if not model.use_viewdirs or len(model.trunk) != 8 or model.skips != (4,):
        raise ValueError("the fused MLP covers depth 8 with viewdirs and a skip at 4")


def _fill(layout, sources) -> torch.Tensor:
    total = sum(rows * cols for _, rows, cols in layout)
    buf = torch.zeros(total, dtype=torch.float64)
    at = 0
    for name, rows, cols in layout:
        piece = buf[at: at + rows * cols].view(rows, cols)
        for src, c0 in sources[name]:
            piece[: src.shape[0], c0: c0 + src.shape[1]] = src.detach()
        at += rows * cols
    return buf


def _build_kernel_weights(model: NeRFMLP, raw_layout: bool) -> torch.Tensor:
    """The KERNEL_LAYOUT staging buffer in float64 from a model on the host."""
    t, sig, bn, v0, rgb = model.trunk, model.sigma_head, model.bottleneck, model.view_0, model.rgb_head
    dev = t[0].weight.device
    pp = _perm_index(10, dev) if raw_layout else slice(None)
    pv = _perm_index(4, dev) if raw_layout else slice(None)
    # each piece: (source [rows, cols] slice, first column in the piece);
    # trunk_5 reads [x(63) | h(256)] and view_0 [bottleneck(256) | views(27)],
    # placed at the kernel's padded columns [x 0..63 | h 64..319] and [.. | 256..287]
    sources = {f"w{i}": ((t[i].weight, 0),) for i in (1, 2, 3, 4, 6, 7)}
    sources.update({f"b{i}": ((t[i].bias[None], 0),) for i in range(8)})
    sources.update(
        w0=((t[0].weight[:, pp], 0),),
        w5=((t[5].weight[:, :63][:, pp], 0), (t[5].weight[:, 63:], 64)),
        wb=((bn.weight, 0),), wv=((v0.weight[:, :256], 0), (v0.weight[:, 256:][:, pv], 256)),
        wsig=((sig.weight, 0),), wrgb=((rgb.weight, 0),),
        bb=((bn.bias[None], 0),), bv=((v0.bias[None], 0),),
        bsig=((sig.bias[None], 0),), brgb=((rgb.bias[None], 0),),
    )
    return _fill(KERNEL_LAYOUT, sources)


def _build_kernel_weights_bwd(model: NeRFMLP) -> torch.Tensor:
    """The KERNEL_LAYOUT_BWD staging buffer in float64 from a model on the host."""
    t = model.trunk
    sources = {f"w{i}": ((t[i].weight.T, 0),) for i in (1, 2, 3, 4, 6, 7)}
    sources.update(
        w5=((t[5].weight[:, 63:].T, 0),), wb=((model.bottleneck.weight.T, 0),),
        wv=((model.view_0.weight[:, :256].T, 0),),
    )
    return _fill(KERNEL_LAYOUT_BWD, sources)


def _pieces(buf: torch.Tensor, layout) -> dict:
    """A flat buffer of ``layout`` -> its [rows, cols] pieces by name."""
    out, at = {}, 0
    for name, rows, cols in layout:
        out[name] = buf[at: at + rows * cols].view(rows, cols)
        at += rows * cols
    return out


SM90_PASS = 128  # rows of N a pass of the wgmma core takes


def sm90_slabs(m: torch.Tensor, n: int, k: int, kd: int) -> torch.Tensor:
    """A [rows <= n, cols <= k] matrix, zero-padded to [n, k] -> its passes
    of at most SM90_PASS rows, each as K-slabs of depth kd, each slab
    [kd / 8][rows / 8][8][8], flat (``SM90_LAYOUT``)."""
    full = m.new_zeros((n, k))
    full[: m.shape[0], : m.shape[1]] = m
    npass = min(n, SM90_PASS)
    out = []
    for p0 in range(0, n, npass):
        for k0 in range(0, k, kd):
            slab = full[p0: p0 + npass, k0: k0 + kd]
            d = slab.shape[1]
            out.append(slab.reshape(npass // 8, 8, d // 8, 8).permute(2, 0, 1, 3).reshape(-1))
    return torch.cat(out)


def sm90_buffer(staged: torch.Tensor, layout, slab_layout, biases) -> torch.Tensor:
    """A staging buffer of ``layout`` -> a wgmma core buffer: each matrix of
    ``slab_layout`` as ``sm90_slabs`` stores it, then each bias of
    ``biases`` zero-padded to its length."""
    p = _pieces(staged, layout)
    mats = [sm90_slabs(p[name], n, k, kd) for name, n, k, kd in slab_layout]
    return torch.cat(mats + [F.pad(p[name].reshape(-1), (0, n - p[name].numel())) for name, n in biases])


def _build_kernel_weights_sm90(model: NeRFMLP, raw_layout: bool) -> torch.Tensor:
    """The wgmma core's forward buffer in float64 from a model on the host."""
    return sm90_buffer(_build_kernel_weights(model, raw_layout), KERNEL_LAYOUT, SM90_LAYOUT, SM90_BIASES)


def _build_kernel_weights_sm90_bwd(model: NeRFMLP) -> torch.Tensor:
    """The wgmma core's dX buffer in float64 from a model on the host."""
    f = _pieces(_build_kernel_weights(model, False), KERNEL_LAYOUT)
    b = _pieces(_build_kernel_weights_bwd(model), KERNEL_LAYOUT_BWD)
    src = {"wrgb": f["wrgb"].T, "wv": b["wv"], "wb": torch.cat([b["wb"], F.pad(f["wsig"].T, (0, 12))], dim=1),
           **{f"w{i}": b[f"w{i}"] for i in (1, 2, 3, 4, 5, 6, 7)}}
    return torch.cat([sm90_slabs(src[name], n, k, kd) for name, n, k, kd in SM90_LAYOUT_BWD])


_GATHER_INDEX: dict = {}


def gather_weights(model: torch.nn.Module, layout, build) -> torch.Tensor:
    """A bf16 kernel buffer gathered from the model's parameters, flattened
    one after another behind a leading 0 (the padding): three launches, no
    wait for the card, nothing kept but the index. ``build(probe)`` makes
    the buffer in float64 from a model on the host; the index is found once
    per ``layout`` key and parameter shapes, by building it over a copy of
    the model whose parameters hold their own positions."""
    params = [p.detach() for p in model.parameters()]
    key = (layout, params[0].device, tuple(p.shape for p in params))
    index = _GATHER_INDEX.get(key)
    if index is None:
        probe = copy.deepcopy(model).to("cpu", torch.float64)
        with torch.no_grad():
            at = 1
            for p in probe.parameters():
                p.copy_(torch.arange(at, at + p.numel(), dtype=torch.float64).view(p.shape))
                at += p.numel()
        index = _GATHER_INDEX[key] = build(probe).long().to(params[0].device)
    flat = torch.cat([params[0].new_zeros(1)] + [p.reshape(-1) for p in params])
    return flat.to(torch.bfloat16)[index]


def kernel_weights_sm90(model: NeRFMLP, raw_layout: bool = False) -> torch.Tensor:
    """The wgmma core's flat bf16 forward buffer (``SM90_LAYOUT`` slabs, then
    ``SM90_BIASES``) from the 8x256 viewdirs ``NeRFMLP``'s parameters (input
    rows permuted to the block encoding with ``raw_layout``): each entry of
    the ``KERNEL_LAYOUT`` staging buffer once, in the slab order. Gathered
    afresh on every call: no cache can miss a write through ``p.data``."""
    _check_arch(model)
    return gather_weights(model, ("fused_mlp_sm90", raw_layout),
                          lambda probe: _build_kernel_weights_sm90(probe, raw_layout))


def kernel_weights_sm90_bwd(model: NeRFMLP) -> torch.Tensor:
    """The wgmma core's flat bf16 dX buffer (``SM90_LAYOUT_BWD``), gathered
    afresh on every call."""
    _check_arch(model)
    return gather_weights(model, ("fused_mlp_sm90_bwd",), _build_kernel_weights_sm90_bwd)


def split_grads(flat: torch.Tensor) -> FusedMLPWeights:
    """A flat [GRAD_ELEMS] gradient buffer -> FusedMLPWeights of views."""
    out, at = [], 0
    for r, c in GRAD_SHAPES:
        out.append(flat[at: at + r * c].view(r, c))
        at += r * c
    return FusedMLPWeights(*out)


def load_library(name: str, api: dict) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library and declare its C functions:
    api maps a function name to (argtypes, restype)."""
    lib = _build.load(name)
    for fn, (args, res) in api.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = res
    return lib


_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fwd_library(name: str):
    """``csrc/<name>.cu`` of a forward kernel (K1f, K1rf)."""
    return load_library(name, {
        name: ([_VP, _VP, _VP, _VP, _LL, _VP], _INT),
        f"{name}_weight_elems": ([], _LL),
        f"{name}_error_string": ([_INT], ctypes.c_char_p),
    })


@functools.lru_cache(maxsize=None)
def _bwd_library(name: str):
    """``csrc/<name>.cu`` of a weight-gradient kernel (K1b, K1rb)."""
    return load_library(name, {
        name: ([_VP] * 6 + [_LL, _VP, _VP], _INT),
        f"{name}_weight_elems": ([], _LL),
        f"{name}_weight_t_elems": ([], _LL),
        f"{name}_grad_elems": ([], _LL),
        f"{name}_workspace_bytes": ([_LL], _LL),
        f"{name}_error_string": ([_INT], ctypes.c_char_p),
    })


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@contextlib.contextmanager
def launch_stream(device: torch.device):
    """The context of every launch: ``device`` made the current CUDA device
    while it lasts, and the handle of its current stream. The C side sets
    no device and launches on the runtime's current one, so without it a
    wrapper whose tensors lie on cuda:1 in a process whose current device
    is cuda:0 would launch on the wrong card, on a stream of another."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(launcher, wk, x, v, x_cols: int, v_cols: int) -> torch.Tensor:
    """The body of a forward launcher (``fused_mlp_fwd``, ``fused_mlp_raw_fwd``,
    whose name is its library's): checks, out [N, 8] float32, the launch,
    and one more on ``launcher.launches``."""
    name = launcher.__name__
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on a CUDA device, got {x.device}")
    lib = _fwd_library(name)
    n, dev = x.shape[0], x.device
    check_tensor(x, "x", torch.float32, (n, x_cols), dev)
    check_tensor(v, "v", torch.float32, (n, v_cols), dev)
    check_tensor(wk, "weights", torch.bfloat16, (getattr(lib, f"{name}_weight_elems")(),), dev)
    out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with launch_stream(dev) as stream:
        rc = getattr(lib, name)(x.data_ptr(), v.data_ptr(), wk.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {getattr(lib, f'{name}_error_string')(rc).decode()}")
    launcher.launches += 1
    return out


def _launch_bwd(launcher, wk, wkt, x, v, g, x_cols: int, v_cols: int) -> FusedMLPWeights:
    """The body of a weight-gradient launcher (``fused_mlp_bwd``,
    ``fused_mlp_raw_bwd``), as ``_launch_fwd``: the padded float32
    gradients, views into one buffer."""
    name = launcher.__name__
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on a CUDA device, got {x.device}")
    lib = _bwd_library(name)
    n, dev = x.shape[0], x.device
    check_tensor(x, "x", torch.float32, (n, x_cols), dev)
    check_tensor(v, "v", torch.float32, (n, v_cols), dev)
    check_tensor(g, "g", torch.float32, (n, 8), dev)
    check_tensor(wk, "weights", torch.bfloat16, (getattr(lib, f"{name}_weight_elems")(),), dev)
    check_tensor(wkt, "weights_bwd", torch.bfloat16, (getattr(lib, f"{name}_weight_t_elems")(),), dev)
    grads = torch.empty(getattr(lib, f"{name}_grad_elems")(), dtype=torch.float32, device=dev)
    if n == 0:
        return split_grads(grads.zero_())
    ws = torch.empty(getattr(lib, f"{name}_workspace_bytes")(n), dtype=torch.uint8, device=dev)
    with launch_stream(dev) as stream:
        rc = getattr(lib, name)(x.data_ptr(), v.data_ptr(), g.data_ptr(), wk.data_ptr(), wkt.data_ptr(),
                                grads.data_ptr(), n, ws.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {getattr(lib, f'{name}_error_string')(rc).decode()}")
    launcher.launches += 1
    return split_grads(grads)


def fused_mlp_fwd(wk: torch.Tensor, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel (K1f): wk a ``kernel_weights_sm90(model)``
    buffer (with ``raw_layout=True``, over ``_encode_raw``'s encodings, it
    gives K1rf's output bit for bit), x [N, 64] and v [N, 32] float32 on
    one card -> [N, 8] float32. Any N >= 0."""
    return _launch_fwd(fused_mlp_fwd, wk, x, v, 64, 32)


def fused_mlp_bwd(wk: torch.Tensor, wkt: torch.Tensor, x: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor) -> FusedMLPWeights:
    """Launch the backward kernel (K1b): wk / wkt the ``kernel_weights_sm90``
    / ``kernel_weights_sm90_bwd`` buffers, x [N, 64], v [N, 32] and the
    output gradient g [N, 8] float32 (all eight columns read) on one card ->
    the padded float32 weight gradients (views into one buffer). Any N >= 0."""
    return _launch_bwd(fused_mlp_bwd, wk, wkt, x, v, g, 64, 32)


def fused_mlp_raw_fwd(wk: torch.Tensor, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch K1rf: wk a ``kernel_weights_sm90(model, raw_layout=True)``
    buffer, p and v [N, 8] float32 raw points and view directions (columns
    0..2 live) on one card -> [N, 8] float32. Any N >= 0."""
    return _launch_fwd(fused_mlp_raw_fwd, wk, p, v, 8, 8)


def fused_mlp_raw_bwd(wk: torch.Tensor, wkt: torch.Tensor, p: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor) -> FusedMLPWeights:
    """Launch K1rb: wk / wkt the ``kernel_weights_sm90(model,
    raw_layout=True)`` / ``kernel_weights_sm90_bwd(model)`` buffers, p and v
    [N, 8] raw inputs and the output gradient g [N, 8] float32 (all eight
    columns read) on one card -> the padded float32 weight gradients in the
    raw layout. Any N >= 0."""
    return _launch_bwd(fused_mlp_raw_bwd, wk, wkt, p, v, g, 8, 8)


fused_mlp_fwd.launches = fused_mlp_bwd.launches = 0
fused_mlp_raw_fwd.launches = fused_mlp_raw_bwd.launches = 0


def forward_weights(model: NeRFMLP, raw: bool) -> torch.Tensor:
    """The buffer a route's forward kernel takes: K1f's (the model's layout)
    or, with ``raw``, K1rf's (the block layout of the in-kernel encoder),
    both on the wgmma core."""
    return kernel_weights_sm90(model, raw_layout=raw)


def backward_weights(model: NeRFMLP, raw: bool, wk: torch.Tensor) -> tuple:
    """The (forward, dX) buffers a route's weight-gradient kernel takes,
    given ``wk`` from ``forward_weights(model, raw)``: K1b and K1rb reuse
    their route's forward gather and gather only the dX buffer, which has
    no raw layout (the dX products never read the permuted input rows)."""
    return wk, kernel_weights_sm90_bwd(model)


class _FusedNeRFMLP(torch.autograd.Function):
    """Forward: K1f on encodings or, with ``raw``, K1rf on raw points (a
    card), or its plain version (the CPU). Backward: K1b / K1rb or the
    plain version, whose padded gradients are mapped onto the model's
    parameters (through the raw layout with ``raw``); x and v get none."""

    @staticmethod
    def forward(ctx, model, raw, x, v, *params):
        ctx.model, ctx.raw = model, raw
        ctx.save_for_backward(x, v)
        if x.device.type == "cuda":
            ctx.wk = forward_weights(model, raw)
            return (fused_mlp_raw_fwd if raw else fused_mlp_fwd)(ctx.wk, x, v)
        plain = fused_nerf_mlp_raw_reference if raw else fused_nerf_mlp_reference
        return plain(pack_params(model, raw_layout=raw), x, v)

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        model, raw = ctx.model, ctx.raw
        g = g.float().contiguous()
        if x.device.type == "cuda":
            grads = (fused_mlp_raw_bwd if raw else fused_mlp_bwd)(*backward_weights(model, raw, ctx.wk), x, v, g)
        else:
            plain = fused_mlp_raw_bwd_reference if raw else fused_mlp_bwd_reference
            grads = plain(pack_params(model, raw_layout=raw), x, v, g)
        named = unpack_grads(grads, model, raw_layout=raw)
        return (None, None, None, None, *(named[name] for name, _ in model.named_parameters()))


def fused_nerf_mlp(model: NeRFMLP, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x [N, 64] points encoding (63 live), v [N, 32] view encoding (27
    live) -> raw [N, 8]: cols 0..2 rgb logits, col 4 sigma logit. The
    kernels on a card, the plain versions on the CPU; differentiable in
    the model's parameters."""
    x, v = x.float().contiguous(), v.float().contiguous()
    return _FusedNeRFMLP.apply(model, False, x, v, *model.parameters())


def fused_nerf_mlp_raw(model: NeRFMLP, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fused_nerf_mlp`` on p, v [N, 8] raw points and unit view
    directions (columns 0..2 live), the positional encoding (10 / 4
    frequencies) done in the kernel."""
    p, v = p.float().contiguous(), v.float().contiguous()
    return _FusedNeRFMLP.apply(model, True, p, v, *model.parameters())


def _pad_inputs(pts_enc: torch.Tensor, views_enc: torch.Tensor):
    n = pts_enc.shape[0]
    return _pad_to(pts_enc.float(), n, 64), _pad_to(views_enc.float(), n, 32)


def _pad_raw(pts: torch.Tensor, viewdirs: torch.Tensor):
    n = pts.shape[0]
    return _pad_to(pts.float(), n, 8), _pad_to(viewdirs.float(), n, 8)


def _rgb_sigma(out: torch.Tensor) -> torch.Tensor:
    return torch.cat([out[:, 0:3], out[:, 4:5]], dim=-1)


def fused_apply(model: NeRFMLP, pts_enc: torch.Tensor, views_enc: torch.Tensor):
    """Drop-in for ``model(pts_enc, views_enc)`` on [N, 63] / [N, 27]
    encodings -> [N, 4] (rgb logits, sigma logit), in bf16 products. No
    row padding: the kernel masks the tail."""
    with span("nerf.encode", device=True):
        x, v = _pad_inputs(pts_enc, views_enc)
    with span("nerf.mlp", device=True):
        out = fused_nerf_mlp(model, x, v)
        del x, v  # a serving chunk's padded encodings go before _rgb_sigma's output comes
        return _rgb_sigma(out)


def fused_apply_reference(W: FusedMLPWeights, pts_enc: torch.Tensor, views_enc: torch.Tensor):
    """``fused_apply`` through the plain version over ``pack_params``
    weights, on any device."""
    return _rgb_sigma(fused_nerf_mlp_reference(W, *_pad_inputs(pts_enc, views_enc)))


def fused_apply_raw(model: NeRFMLP, pts: torch.Tensor, viewdirs: torch.Tensor):
    """The MLP on raw [N, 3] points and [N, 3] unit view directions ->
    [N, 4] (rgb logits, sigma logit), encoding in the kernel (multires
    10 / 4). No row padding: the kernel masks the tail. It carries no
    ``accepts_raw_points`` tag, as the reference's does not: a caller of
    ``render_rays`` tags a wrapper of its own."""
    return _rgb_sigma(fused_nerf_mlp_raw(model, *_pad_raw(pts, viewdirs)))


def fused_apply_raw_reference(W: FusedMLPWeights, pts: torch.Tensor, viewdirs: torch.Tensor):
    """``fused_apply_raw`` through K1rf's plain version over
    ``pack_params(raw_layout=True)`` weights, on any device."""
    return _rgb_sigma(fused_nerf_mlp_raw_reference(W, *_pad_raw(pts, viewdirs)))
