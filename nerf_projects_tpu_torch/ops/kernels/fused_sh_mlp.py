"""Fully fused NeRF-SH trunk, forward and weight-gradient backward (port
of ``nerf_projects_tpu/ops/pallas/fused_sh_mlp.py``).

Architecture (models/nerf_sh.py ``CondMLP`` without a condition, depth 8,
width 256, skip at 4): trunk dense 0..7 with the [h, x] concat after
dense 4 (h first, the jaxnerf order), the sigma head (dense 8, one
column) and the coefficient head (dense 9, ``num_rgb`` <= 128 columns).
``FusedSHWeights`` / ``pack_sh_params`` pad as the TPU kernel does (points
63 -> 64, heads to 128 columns; bf16 weights and biases).

Kernels (CUDA C++ for sm_90a under ``csrc/``, built with nvcc and loaded
with ctypes), each with a launch counter and its plain PyTorch version,
both on the NeRF MLP's wgmma core (``csrc/mlp_sm90.cuh``):

- ``fused_sh_fwd`` (``csrc/fused_sh_fwd.cu``, K5f): x [n, 63] -> the
  coefficient head [n, num_rgb] and the sigma head [n, 1], over
  ``kernel_weights_sm90(mlp)``; plain: ``fused_sh_mlp_reference`` over
  ``pack_sh_params``.
- ``fused_sh_bwd`` (``csrc/fused_sh_bwd.cu``, K5b): the padded weight
  gradients from x and the heads' output gradients, recomputing the
  trunk, over the same buffer and the dX buffer
  ``kernel_weights_sm90_bwd(mlp)``; plain: ``fused_sh_bwd_reference``,
  with the same bf16 rounding points.

``forward_weights`` / ``backward_weights`` say which buffers the route
hands each kernel: K5b reuses the forward's gather and gathers only the
dX buffer. Both kernels keep the activation columns as [x | h], so the
forward buffer holds dense 5's input columns permuted to [x | h]
(``_build_kernel_weights``) and K5b's gradient buffer holds w5's rows in
that order, which ``split_kernel_grads`` un-permutes to the reference's
[h | x].

``fused_sh_apply`` takes a ``CondMLP`` and is differentiable in its
parameters: an autograd Function runs the kernels on a card and the plain
versions on the CPU (no fallback from one to the other). The encoded
points get no gradient, as on the TPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from nerf_projects_tpu_torch.ops.kernels import fused_mlp as fm

MAX_RGB = 128
# live multiply-adds a row: the trunk, then per head column 256
TRUNK_MACS = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256
DX_MACS = 7 * 256 * 256  # dense 7's gradient down to dense 0's, w5's h rows only


def fwd_macs(num_rgb: int) -> int:
    """Live multiply-adds a row of the forward (503,552 at sh_deg 3)."""
    return TRUNK_MACS + 256 * (num_rgb + 1)


def bwd_macs(num_rgb: int) -> dict:
    """Live multiply-adds a row of the backward, itemised: the recomputed
    trunk, the dX products (the heads' into dense 7, then down to dense
    0's output) and dW of all ten layers."""
    return {"trunk": TRUNK_MACS, "dx": DX_MACS + 256 * (num_rgb + 1), "dw": fwd_macs(num_rgb)}


# K5b's bf16 stashes a row (sh::A_FEATS + sh::G_FEATS of csrc/mlp_tile.cuh),
# rows padded to 128: x and a0..a7, then the heads' and dense 0..7's output
# gradients
STASH_BYTES_PER_ROW = 2 * ((64 + 8 * 256) + (MAX_RGB + 8 + 8 * 256))


def io_bytes(num_rgb: int) -> int:
    """Bytes a row in and out of either kernel: x [63], and the heads'
    num_rgb + 1 outputs (forward) or their gradients (backward), float32."""
    return (63 + num_rgb + 1) * 4


class FusedSHWeights(NamedTuple):
    """Padded bf16 weights [in, out] and biases [1, out], as the reference's."""

    w0: torch.Tensor    # [64, 256]
    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    w4: torch.Tensor
    w5: torch.Tensor    # [320, 256]: rows [h(256) | x(64, 63 live)]
    w6: torch.Tensor
    w7: torch.Tensor
    wsig: torch.Tensor  # [256, 128] col 0 live
    wrgb: torch.Tensor  # [256, 128] cols 0..num_rgb-1 live
    b0: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    b3: torch.Tensor
    b4: torch.Tensor
    b5: torch.Tensor
    b6: torch.Tensor
    b7: torch.Tensor
    bsig: torch.Tensor
    brgb: torch.Tensor


def check_arch(mlp) -> None:
    """The fused trunk covers exactly this CondMLP: no condition, dense
    0..7 of width 256 on 63 encoded inputs with the skip after dense 4,
    one sigma channel and at most 128 coefficient columns."""
    d = getattr(mlp, "dense", None)
    ok = (
        d is not None and len(d) == 10 and d[0].in_features == 63 and d[5].in_features == 319
        and all(d[i].out_features == 256 for i in range(8))
        and d[8].out_features == 1 and d[9].in_features == 256 and d[9].out_features <= MAX_RGB
    )
    if not ok:
        raise ValueError("the fused SH trunk covers depth 8, width 256, skip 4, 63 inputs, "
                         "one sigma channel and at most 128 coefficients, with no condition")


def pack_sh_params(mlp, dtype=torch.bfloat16) -> FusedSHWeights:
    """The port's condition-free ``CondMLP`` -> padded kernel weights, as
    the reference's ``pack_sh_params``."""
    check_arch(mlp)
    d = mlp.dense

    def kb(i, rows, cols):
        k = d[i].weight.detach().T
        b = d[i].bias.detach()[None, :]
        return fm._pad_to(k, rows, cols).to(dtype), fm._pad_to(b, 1, cols).to(dtype)

    w0, b0 = kb(0, 64, 256)
    w1, b1 = kb(1, 256, 256)
    w2, b2 = kb(2, 256, 256)
    w3, b3 = kb(3, 256, 256)
    w4, b4 = kb(4, 256, 256)
    # dense 5 consumes [h(256), x(63)]: rows [256 | 63], x padded to 64
    w5, b5 = kb(5, 320, 256)
    w6, b6 = kb(6, 256, 256)
    w7, b7 = kb(7, 256, 256)
    wsig, bsig = kb(8, 256, 128)
    wrgb, brgb = kb(9, 256, 128)
    return FusedSHWeights(w0, w1, w2, w3, w4, w5, w6, w7, wsig, wrgb,
                          b0, b1, b2, b3, b4, b5, b6, b7, bsig, brgb)


def unpack_sh_grads(g: FusedSHWeights, mlp) -> dict:
    """Padded weight gradients (reference row order) -> float32 gradients
    of the CondMLP's parameters by name (``nn.Linear`` shapes)."""
    kernels = (g.w0, g.w1, g.w2, g.w3, g.w4, g.w5, g.w6, g.w7, g.wsig, g.wrgb)
    biases = (g.b0, g.b1, g.b2, g.b3, g.b4, g.b5, g.b6, g.b7, g.bsig, g.brgb)
    out = {}
    for i, layer in enumerate(mlp.dense):
        o, n_in = layer.weight.shape
        out[f"dense.{i}.weight"] = kernels[i][:n_in, :o].T.float().contiguous()
        out[f"dense.{i}.bias"] = biases[i][0, :o].float().contiguous()
    return out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _pad_points(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x.float(), (0, 64 - x.shape[-1]))


def _fwd_tile(W: FusedSHWeights, x: torch.Tensor):
    """The reference's ``_fwd_tile`` on x [N, 64]: (coefficient head [N,
    128], sigma head [N, 128], float32 activations by name)."""
    mm = fm._mm
    acts = {}
    h = torch.relu(mm(x, W.w0) + W.b0.float())
    acts["a0"] = h
    for i, (w, b) in enumerate(((W.w1, W.b1), (W.w2, W.b2), (W.w3, W.b3), (W.w4, W.b4)), start=1):
        h = torch.relu(mm(h, w) + b.float())
        acts[f"a{i}"] = h
    cat = torch.cat([h, x.float()], dim=-1)  # h first
    acts["cat"] = cat
    h = torch.relu(mm(cat, W.w5) + W.b5.float())
    acts["a5"] = h
    h = torch.relu(mm(h, W.w6) + W.b6.float())
    acts["a6"] = h
    h = torch.relu(mm(h, W.w7) + W.b7.float())
    acts["a7"] = h
    sig = mm(h, W.wsig) + W.bsig.float()
    rgb = mm(h, W.wrgb) + W.brgb.float()
    return rgb, sig, acts


def fused_sh_mlp_reference(W: FusedSHWeights, x: torch.Tensor, num_rgb: int):
    """Plain PyTorch version of the forward kernel: x [N, 63] float32 ->
    (coefficients [N, num_rgb], sigma [N, 1]) float32. Mirrors
    ``_fwd_tile``: every product rounds its left operand to bf16 and
    accumulates in float32; biases add in float32. On a card the matmuls
    run with TF32 off."""
    with fm._full_fp32_matmul(x.device):
        rgb, sig, _ = _fwd_tile(W, _pad_points(x))
        return rgb[:, :num_rgb], sig[:, :1]


def fused_sh_bwd_reference(W: FusedSHWeights, x: torch.Tensor, g_rgb: torch.Tensor,
                           g_sig: torch.Tensor) -> FusedSHWeights:
    """Plain version of the backward kernel (the reference's
    ``_bwd_kernel``): x [N, 63] and the heads' output gradients g_rgb [N,
    num_rgb], g_sig [N, 1] -> the padded float32 gradients of ``W``,
    recomputing the forward. ``mmT`` rounds both operands to bf16,
    ``mmBT`` rounds g; relu masks come from a float32 ``> 0``; bias
    gradients are float32 sums (``fm.float64_sums`` makes every sum
    float64)."""
    mmT, mmBT = fm._mmT, fm._mmBT

    def pos(a):
        return (a > 0).float()

    x = _pad_points(x)
    g_rgb = F.pad(g_rgb.float(), (0, MAX_RGB - g_rgb.shape[-1]))
    g_sig = F.pad(g_sig.float()[:, :1], (0, MAX_RGB - 1))
    with fm._full_fp32_matmul(x.device):
        _, _, acts = _fwd_tile(W, x)
        gr = {}
        gr["wrgb"] = mmT(acts["a7"], g_rgb)
        gr["brgb"] = g_rgb.sum(0, keepdim=True)
        gr["wsig"] = mmT(acts["a7"], g_sig)
        gr["bsig"] = g_sig.sum(0, keepdim=True)
        g_h = (mmBT(g_rgb, W.wrgb) + mmBT(g_sig, W.wsig)) * pos(acts["a7"])
        gr["w7"] = mmT(acts["a6"], g_h)
        gr["b7"] = g_h.sum(0, keepdim=True)
        g_h = mmBT(g_h, W.w7) * pos(acts["a6"])
        gr["w6"] = mmT(acts["a5"], g_h)
        gr["b6"] = g_h.sum(0, keepdim=True)
        g_h = mmBT(g_h, W.w6) * pos(acts["a5"])
        gr["w5"] = mmT(acts["cat"], g_h)
        gr["b5"] = g_h.sum(0, keepdim=True)
        g_h = mmBT(g_h, W.w5)[:, :256] * pos(acts["a4"])  # the h rows come first
        for i in (4, 3, 2, 1):
            gr[f"w{i}"] = mmT(acts[f"a{i - 1}"], g_h)
            gr[f"b{i}"] = g_h.sum(0, keepdim=True)
            g_h = mmBT(g_h, getattr(W, f"w{i}")) * pos(acts[f"a{i - 1}"])
        gr["w0"] = mmT(x, g_h)
        gr["b0"] = g_h.sum(0, keepdim=True)
        return FusedSHWeights(**gr)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

# The staging layout K5's buffers are built from (in float64, over the
# CondMLP's parameters): (field, rows, cols) of each piece, [out][in] as
# nn.Linear holds it, dense 5's inputs as the kernels read them ([x 64 |
# h 256]); the coefficient head keeps MAX_RGB rows, those past num_rgb zero.
KERNEL_LAYOUT = (
    ("w0", 256, 64), ("w1", 256, 256), ("w2", 256, 256), ("w3", 256, 256),
    ("w4", 256, 256), ("w5", 256, 320), ("w6", 256, 256), ("w7", 256, 256),
    ("wsig", 1, 256), ("wrgb", MAX_RGB, 256),
    ("b0", 1, 256), ("b1", 1, 256), ("b2", 1, 256), ("b3", 1, 256),
    ("b4", 1, 256), ("b5", 1, 256), ("b6", 1, 256), ("b7", 1, 256),
    ("bsig", 1, 8), ("brgb", 1, MAX_RGB),
)

# FusedSHWeights' padded shapes: the layout of the kernel's gradient buffer
# (sh::GW* in csrc/mlp_tile.cuh)
GRAD_SHAPES = (
    (64, 256), (256, 256), (256, 256), (256, 256), (256, 256), (320, 256),
    (256, 256), (256, 256), (256, 128), (256, 128),
) + ((1, 256),) * 8 + ((1, 128), (1, 128))
GRAD_ELEMS = sum(r * c for r, c in GRAD_SHAPES)


def _build_kernel_weights(mlp) -> torch.Tensor:
    """The KERNEL_LAYOUT staging buffer in float64 from a CondMLP on the
    host. Dense 5's input columns go to the kernels' [x 0..63 | h 64..319]."""
    d = mlp.dense
    sources = {f"w{i}": ((d[i].weight, 0),) for i in range(8) if i != 5}
    sources.update({f"b{i}": ((d[i].bias[None], 0),) for i in range(8)})
    sources.update(
        w5=((d[5].weight[:, 256:], 0), (d[5].weight[:, :256], 64)),
        wsig=((d[8].weight, 0),), wrgb=((d[9].weight, 0),),
        bsig=((d[8].bias[None], 0),), brgb=((d[9].bias[None], 0),),
    )
    return fm._fill(KERNEL_LAYOUT, sources)


# K5's buffers on the wgmma core (csrc/mlp_sm90.cuh): (field, N, K, KD) of
# each layer's [N][K] matrix as fused_mlp.sm90_slabs stores it. The forward
# (the trunk at SW_W0.., then SH_*): KERNEL_LAYOUT's pieces with the sigma
# head padded to 8 rows; then the biases, the sigma head's padded to 8.
SM90_LAYOUT = (
    ("w0", 256, 64, 64), ("w1", 256, 256, 64), ("w2", 256, 256, 64), ("w3", 256, 256, 64),
    ("w4", 256, 256, 64), ("w5", 256, 320, 64), ("w6", 256, 256, 64), ("w7", 256, 256, 64),
    ("wsig", 8, 256, 256), ("wrgb", MAX_RGB, 256, 64),
)
SM90_BIASES = tuple((f"b{i}", 256) for i in range(8)) + (("bsig", 8), ("brgb", MAX_RGB))
# The dX products' matrices [N = in][K = out] (SWT_SH_*): the heads' as one
# [256][MAX_RGB + 16] matrix, the coefficient head's transpose (columns past
# num_rgb zero) then the sigma head's (K padded to 16), into dense 7; then
# w7, w6, w5's h rows, w4..w1 transposed.
SM90_LAYOUT_BWD = (("wh", 256, MAX_RGB + 16, 64),) + tuple((f"w{i}", 256, 256, 64) for i in range(7, 0, -1))


def _build_kernel_weights_sm90(mlp) -> torch.Tensor:
    """K5f's (and K5b's) forward buffer in float64 from a CondMLP on the host."""
    return fm.sm90_buffer(_build_kernel_weights(mlp), KERNEL_LAYOUT, SM90_LAYOUT, SM90_BIASES)


def _build_kernel_weights_sm90_bwd(mlp) -> torch.Tensor:
    """K5b's dX buffer in float64 from a CondMLP on the host."""
    d = mlp.dense
    wh = d[9].weight.new_zeros(256, MAX_RGB + 16)
    wh[:, : d[9].out_features] = d[9].weight.detach().T
    wh[:, MAX_RGB] = d[8].weight.detach()[0]
    src = {"wh": wh, "w5": d[5].weight.detach()[:, :256].T,
           **{f"w{i}": d[i].weight.detach().T for i in (1, 2, 3, 4, 6, 7)}}
    return torch.cat([fm.sm90_slabs(src[name], n, k, kd) for name, n, k, kd in SM90_LAYOUT_BWD])


def kernel_weights_sm90(mlp) -> torch.Tensor:
    """The flat bf16 forward buffer on the wgmma core (``SM90_LAYOUT``
    slabs, then ``SM90_BIASES``), which K5f and K5b read: each entry of the
    ``KERNEL_LAYOUT`` staging buffer once, gathered afresh from the
    CondMLP's parameters on every call (no cache can miss a write through
    ``p.data``)."""
    check_arch(mlp)
    return fm.gather_weights(mlp, ("fused_sh_sm90",), _build_kernel_weights_sm90)


def kernel_weights_sm90_bwd(mlp) -> torch.Tensor:
    """K5b's flat bf16 dX buffer (``SM90_LAYOUT_BWD``), gathered afresh on
    every call."""
    check_arch(mlp)
    return fm.gather_weights(mlp, ("fused_sh_sm90_bwd",), _build_kernel_weights_sm90_bwd)


def split_kernel_grads(flat: torch.Tensor) -> FusedSHWeights:
    """The kernel's flat [GRAD_ELEMS] gradient buffer -> FusedSHWeights in
    the reference's layout: w5's rows un-permuted from the kernel's
    [x 64 | h 256] to [h 256 | x 64]."""
    out, at = [], 0
    for r, c in GRAD_SHAPES:
        out.append(flat[at: at + r * c].view(r, c))
        at += r * c
    w5 = out[5]
    out[5] = torch.cat([w5[64:], w5[:64]])
    return FusedSHWeights(*out)


_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fwd_library():
    return fm.load_library("fused_sh_fwd", {
        "fused_sh_fwd": ([_VP, _VP, _VP, _VP, _LL, _INT, _VP], _INT),
        "fused_sh_fwd_weight_elems": ([], _LL),
        "fused_sh_fwd_error_string": ([_INT], ctypes.c_char_p),
    })


@functools.lru_cache(maxsize=None)
def _bwd_library():
    return fm.load_library("fused_sh_bwd", {
        "fused_sh_bwd": ([_VP] * 6 + [_LL, _INT, _VP, _VP], _INT),
        "fused_sh_bwd_weight_elems": ([], _LL),
        "fused_sh_bwd_weight_t_elems": ([], _LL),
        "fused_sh_bwd_grad_elems": ([], _LL),
        "fused_sh_bwd_workspace_bytes": ([_LL], _LL),
        "fused_sh_bwd_error_string": ([_INT], ctypes.c_char_p),
    })


def _check_num_rgb(num_rgb: int) -> None:
    if not 1 <= num_rgb <= MAX_RGB:
        raise ValueError(f"num_rgb must be in 1..{MAX_RGB}, got {num_rgb}")


def fused_sh_fwd(wk: torch.Tensor, x: torch.Tensor, num_rgb: int):
    """Launch the forward kernel (K5f): wk a ``kernel_weights_sm90`` buffer,
    x [N, 63] float32 on one card -> (coefficients [N, num_rgb], sigma
    [N, 1]) float32. Any N >= 0."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_sh_fwd runs on a CUDA device, got {x.device}")
    _check_num_rgb(num_rgb)
    lib = _fwd_library()
    n, dev = x.shape[0], x.device
    fm.check_tensor(x, "x", torch.float32, (n, 63), dev)
    fm.check_tensor(wk, "weights", torch.bfloat16, (lib.fused_sh_fwd_weight_elems(),), dev)
    rgb = torch.empty((n, num_rgb), dtype=torch.float32, device=dev)
    sig = torch.empty((n, 1), dtype=torch.float32, device=dev)
    if n == 0:
        return rgb, sig
    with torch.cuda.device(dev):
        rc = lib.fused_sh_fwd(x.data_ptr(), wk.data_ptr(), rgb.data_ptr(), sig.data_ptr(), n, num_rgb,
                              fm.current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"fused_sh_fwd launch failed: {lib.fused_sh_fwd_error_string(rc).decode()}")
    fused_sh_fwd.launches += 1
    return rgb, sig


fused_sh_fwd.launches = 0


def fused_sh_bwd(wk: torch.Tensor, wkt: torch.Tensor, x: torch.Tensor, g_rgb: torch.Tensor,
                 g_sig: torch.Tensor) -> FusedSHWeights:
    """Launch the backward kernel (K5b): wk / wkt the
    ``kernel_weights_sm90`` / ``kernel_weights_sm90_bwd`` buffers, x [N,
    63], the heads' output gradients g_rgb [N, num_rgb] and g_sig [N, 1]
    float32 on one card -> the padded float32 weight gradients in the
    reference's layout. Any N >= 0."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_sh_bwd runs on a CUDA device, got {x.device}")
    lib = _bwd_library()
    n, dev = x.shape[0], x.device
    num_rgb = g_rgb.shape[-1]
    _check_num_rgb(num_rgb)
    fm.check_tensor(x, "x", torch.float32, (n, 63), dev)
    fm.check_tensor(g_rgb, "g_rgb", torch.float32, (n, num_rgb), dev)
    fm.check_tensor(g_sig, "g_sig", torch.float32, (n, 1), dev)
    fm.check_tensor(wk, "weights", torch.bfloat16, (lib.fused_sh_bwd_weight_elems(),), dev)
    fm.check_tensor(wkt, "weights_bwd", torch.bfloat16, (lib.fused_sh_bwd_weight_t_elems(),), dev)
    grads = torch.empty(lib.fused_sh_bwd_grad_elems(), dtype=torch.float32, device=dev)
    if n == 0:
        return split_kernel_grads(grads.zero_())
    ws = torch.empty(lib.fused_sh_bwd_workspace_bytes(n), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fused_sh_bwd(x.data_ptr(), g_rgb.data_ptr(), g_sig.data_ptr(), wk.data_ptr(), wkt.data_ptr(),
                              grads.data_ptr(), n, num_rgb, ws.data_ptr(), fm.current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"fused_sh_bwd launch failed: {lib.fused_sh_bwd_error_string(rc).decode()}")
    fused_sh_bwd.launches += 1
    return split_kernel_grads(grads)


fused_sh_bwd.launches = 0


def forward_weights(mlp) -> torch.Tensor:
    """The buffer the route hands K5f: the wgmma core's."""
    return kernel_weights_sm90(mlp)


def backward_weights(mlp, wk: torch.Tensor) -> tuple:
    """The (forward, dX) buffers the route hands K5b, given ``wk`` from
    ``forward_weights(mlp)``: K5b recomputes the trunk from the forward's
    gather and gathers only the dX buffer."""
    return wk, kernel_weights_sm90_bwd(mlp)


class _FusedSH(torch.autograd.Function):
    """Forward: the forward kernel (card) or its plain version (CPU).
    Backward: the backward kernel or its plain version, whose padded
    gradients are mapped onto the CondMLP's parameters; x gets none."""

    @staticmethod
    def forward(ctx, mlp, x, num_rgb, *params):
        ctx.mlp = mlp
        ctx.save_for_backward(x)
        if x.device.type == "cuda":
            ctx.wk = forward_weights(mlp)
            return fused_sh_fwd(ctx.wk, x, num_rgb)
        return fused_sh_mlp_reference(pack_sh_params(mlp), x, num_rgb)

    @staticmethod
    def backward(ctx, g_rgb, g_sig):
        (x,) = ctx.saved_tensors
        mlp = ctx.mlp
        g_rgb, g_sig = g_rgb.float().contiguous(), g_sig.float().contiguous()
        if x.device.type == "cuda":
            grads = fused_sh_bwd(*backward_weights(mlp, ctx.wk), x, g_rgb, g_sig)
        else:
            grads = fused_sh_bwd_reference(pack_sh_params(mlp), x, g_rgb, g_sig)
        named = unpack_sh_grads(grads, mlp)
        return (None, None, None, *(named[name] for name, _ in mlp.named_parameters()))


def fused_sh_apply(mlp, pts_enc: torch.Tensor, num_rgb: int):
    """Drop-in for ``CondMLP(pts_enc)`` without a condition: [N, 63]
    encodings -> (raw_rgb [N, num_rgb], raw_sigma [N, 1]) in bf16
    products. The kernels on a card, the plain versions on the CPU;
    differentiable in the CondMLP's parameters. No row padding: the
    kernel masks the tail."""
    check_arch(mlp)
    if num_rgb != mlp.dense[9].out_features:
        raise ValueError(f"num_rgb {num_rgb} is not the head's {mlp.dense[9].out_features} columns")
    x = pts_enc.float().contiguous()
    return _FusedSH.apply(mlp, x, num_rgb, *mlp.parameters())
