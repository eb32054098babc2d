"""Row-sparse Plenoxels training: O(touched bricks) a step (port of
``nerf_projects_tpu/train/plenoxels_sparse.py``).

The dense tile step (``PlenoxelsTrainer.train_step_tiles_pallas``) pays
three whole-grid costs every step: the bf16 cells rebuilt from the
float32 masters, the sampled TV and the cell mask added into dense
gradient arrays, and the RMSprop sweep over every cell. The steps here
remove them:

  * the bf16 cells that K3 and K4 read are kept in the state and
    rewritten only on the rows a step touches;
  * K4 flags the bricks it adds a gradient into (``fused_grad_blocks``);
    the flags and the TV window's rows are compacted into a slot list of
    ``max_touched`` rows without a sort and without a host sync (flag ->
    exclusive cumsum -> slot), the gradients gathered onto those rows and
    the TV blocks added at their slots;
  * RMSprop runs only on those rows, with the exact lazy decay of the
    dense recursion: a row untouched for D steps has a zero gradient
    there, so rms <- b rms D times is rms b^D, applied in closed form
    from the row's ``last_step`` stamp (reference optim_kernel.cu:20-27).
    Under per-visit RMSprop (``trainer.rms_pervisit``) rms decays only
    where this step's gradient is nonzero, per coefficient.

The flags are exact for this: a row flagged with a zero gradient only
gets its b^D decay early, and under per-visit RMSprop ``where(g == 0)``
leaves it as it was. K4's wrapper still zeroes its dense gradient
arrays each step; no other pass covers the whole state.

Layout (the port's, field names kept from the JAX package so each has
its counterpart): every row-indexed array has nb + 1 rows, row nb the
sentinel (always zero; empty slots of the slot list point at it).
``SparseBrickState``: float32 masters ``density_k`` [nb + 1, 512] and
``sh_k`` [nb + 1, 512, 3B] (the brick layout, channels c * B + b), their
rms of the same shapes, ``last_step`` int32 [nb + 1] (-1: never) and
``cells`` bf16 [nb + 1, 512, CP], the march's copy (``tile_march.channels``:
channel 0 density, then the 3B SH channels, zero padding), in place of
JAX's ``density_z`` / ``sh_z`` (views of it under those names).
``PackedState``: ``packed_k`` float32 [nb + 1, 512, CP], the cells'
layout, its ``rms``, ``last_step`` and the bf16 ``cells`` copy.

Precision. K3 and K4 read bf16 cells only. On host tensors a state
without a bf16 copy (JAX's ``shared_kernel_arrays=True``, and every
packed state, which JAX marches on its float32 masters) marches the
float32 masters through the plain versions, as JAX does. On the card the
state keeps a bf16 copy in every case: its outputs lie within the JAX
package's bf16 cells-against-float32 bound (2e-2 of scale,
``tests/test_tile_march_pallas.py``) of a float32 march. A float32-cell
K3/K4 is still to be written (ROADMAP).

Each step takes the step number as a host number (the learning rates'
schedule position, and the stamp written to ``last_step``, an int32 on
the state's device) and a ``torch.Generator`` that draws the TV windows,
which should live on the grid's device. No step waits for the card. A
touched-row step writes its rows into the state's tensors in place (JAX's
jitted steps donate their state) and returns the state; a dense step
returns new tensors. The TV over bricks is ``ops/tv_bricks.py``.

Row-sharded state (``mesh=`` on ``train_step_tiles_sparse`` and
``train_step_tiles_packed_touched``; JAX's tests/test_parallel.py:84-226
and ``dryrun_multichip``, where GSPMD partitions the same steps): over a
mesh's "rays" axis of W ranks, each rank's float32 masters, RMSprop
arrays and ``last_step`` hold only its contiguous rows [r N / W, (r + 1)
N / W) of the state padded to N rows (``pad_state_rows``), plus one spare
row at the end; every rank keeps the whole march copy ``cells`` and
marches the whole ray batch (JAX replicates the rays). Each rank updates
only the touched rows it owns, writing the slots it does not own into its
spare row; then the ranks ``all_gather`` the rewritten rows and every
rank takes each row from its owner, so the cells stay the same on every
rank. Only a row's owner writes it: K4's atomic sums vary in their last
bits from run to run, so replicas that wrote their own copies would
drift. The TV window's reads fetch each row from its owner the same way.
``shard_state_rows`` makes such a state and ``gather_state_rows``
reassembles it. The float32 state per rank is about 1/W of one
process's.

Unsupported here (use the dense step): ``lambda_l2_sh`` and
``lambda_tv_lumisphere`` touch every cell every step by definition.

Parity target: reference svox2/opt/opt.py:699-842 fused step; its CUDA
is sparse in the same sense (atomics into the touched cells) but pairs it
with a whole-grid optimizer sweep (svox2.py:1540-1557).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from nerf_projects_tpu_torch.core.rays import Rays
from nerf_projects_tpu_torch.obs.trace import count, count_device, span
from nerf_projects_tpu_torch.ops.brick_grid import BRICK, BrickGrid
from nerf_projects_tpu_torch.ops.kernels.tile_march import (
    BASIS_DIMS,
    active_chunk_bound,
    channels,
    default_chunks_for,
    fused_grad_blocks,
    march_inputs,
    march_reference,
)
from nerf_projects_tpu_torch.ops.tv_bricks import sample_brick_window, tv_grad_brick_blocks
from nerf_projects_tpu_torch.parallel.mesh import RAY_AXIS, all_gather_rows, axis_info

CELLS = BRICK**3


class SparseBrickState(NamedTuple):
    density_k: torch.Tensor     # f32 [nb + 1, 512] master
    sh_k: torch.Tensor          # f32 [nb + 1, 512, 3B] master
    cells: Optional[torch.Tensor]  # bf16 [nb + 1, 512, CP] march copy, or None: march the masters (host)
    rms_density: torch.Tensor   # [nb + 1, 512]
    rms_sh: torch.Tensor        # [nb + 1, 512, 3B]
    last_step: torch.Tensor     # int32 [nb + 1], -1 = never touched

    @property
    def n_bricks(self) -> int:
        return self.density_k.shape[0] - 1

    @property
    def basis_dim(self) -> int:
        return self.sh_k.shape[-1] // 3

    @property
    def density_z(self) -> Optional[torch.Tensor]:
        """JAX's bf16 density copy: channel 0 of ``cells``."""
        return None if self.cells is None else self.cells[..., 0]

    @property
    def sh_z(self) -> Optional[torch.Tensor]:
        """JAX's bf16 SH copy: channels 1 .. 3B of ``cells``."""
        return None if self.cells is None else self.cells[..., 1:1 + 3 * self.basis_dim]


class PackedState(NamedTuple):
    """The whole trainable state in the march's layout: ``packed_k``
    float32 [nb + 1, 512, CP] (channel 0 density, then the 3B SH
    channels, zero padding), ``rms`` of the same shape, ``last_step``
    int32 [nb + 1] (-1 = never touched; the touched-row step's lazy decay,
    carried unchanged by the dense packed step) and ``cells``, its bf16
    copy for K3 and K4 (None: march ``packed_k``, the host's plain
    versions only)."""

    packed_k: torch.Tensor
    rms: torch.Tensor
    last_step: Optional[torch.Tensor] = None
    cells: Optional[torch.Tensor] = None

    @property
    def basis_dim(self) -> int:
        cp = self.packed_k.shape[-1]
        return max(b for b in BASIS_DIMS if channels(b) == cp)


def _append_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.zeros_like(x[:1])], dim=0)


def _pack(density: torch.Tensor, sh: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Rows of density [n, 512] and SH [n, 512, 3B] -> cells [n, 512, CP]."""
    B = sh.shape[-1] // 3
    out = torch.zeros(density.shape[:1] + (CELLS, channels(B)), dtype=dtype, device=density.device)
    out[..., 0] = density
    out[..., 1:1 + 3 * B] = sh
    return out


def sparse_state_from_grid(bg: BrickGrid, rms_dtype=torch.float32, shared_kernel_arrays: bool = False,
                           ) -> SparseBrickState:
    """The incremental state from a BrickGrid's float32 masters.

    rms_dtype=torch.bfloat16 halves the RMSprop accumulator: it only
    feeds sqrt(rms) + eps in the denominator, so bf16's ~0.4% relative
    error is step-size noise. ``shared_kernel_arrays``: no bf16 copy, the
    march reads the float32 masters (host tensors only; on the card the
    state keeps the copy, see the module's docstring)."""
    nb = bg.n_bricks
    dk = _append_row(bg.density_bricks.reshape(nb, CELLS).float())
    sk = _append_row(bg.sh_bricks.float())
    copy = not shared_kernel_arrays or bg.device.type == "cuda"
    return SparseBrickState(
        density_k=dk,
        sh_k=sk,
        cells=_pack(dk, sk, torch.bfloat16) if copy else None,
        rms_density=torch.zeros(dk.shape, dtype=rms_dtype, device=dk.device),
        rms_sh=torch.zeros(sk.shape, dtype=rms_dtype, device=dk.device),
        last_step=torch.full((nb + 1,), -1, dtype=torch.int32, device=dk.device),
    )


def _pad_rows(x: Optional[torch.Tensor], pad: int, fill=0):
    if x is None:
        return None
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)])


def pad_state_rows(st: SparseBrickState, multiple: int) -> SparseBrickState:
    """Pad every row-indexed array to a multiple of ``multiple`` rows (for
    a row-sharded state). Padding rows sit after the sentinel (row nb)
    and are never referenced; ``grid_from_sparse_state`` slices by the
    grid's nb, so the padding round-trips away."""
    pad = (-st.density_k.shape[0]) % multiple
    if pad == 0:
        return st
    return SparseBrickState(*(_pad_rows(x, pad) for x in st[:5]), last_step=_pad_rows(st.last_step, pad, -1))


def grid_from_sparse_state(bg: BrickGrid, st: SparseBrickState) -> BrickGrid:
    """The trained masters written back into (a copy of) ``bg``, bit for
    bit."""
    nb = bg.n_bricks
    return dataclasses.replace(bg, density_bricks=st.density_k[:nb].clone(), sh_bricks=st.sh_k[:nb].clone())


def packed_state_from_grid(bg: BrickGrid, rms_dtype=torch.float32, bf16_cells: Optional[bool] = None,
                           ) -> PackedState:
    """The packed state from a BrickGrid's masters. ``bf16_cells``: keep
    the bf16 copy that K3 and K4 read (None: on the card only; on the
    host the plain versions march the float32 masters, as JAX does)."""
    nb = bg.n_bricks
    packed = _append_row(_pack(bg.density_bricks.reshape(nb, CELLS).float(), bg.sh_bricks.float()))
    return PackedState(
        packed_k=packed,
        rms=torch.zeros(packed.shape, dtype=rms_dtype, device=packed.device),
        last_step=torch.full((nb + 1,), -1, dtype=torch.int32, device=packed.device),
        cells=packed.to(torch.bfloat16) if (bg.device.type == "cuda" if bf16_cells is None else bf16_cells) else None,
    )


def pad_packed_state_rows(st: PackedState, multiple: int) -> PackedState:
    """The PackedState twin of ``pad_state_rows``."""
    pad = (-st.packed_k.shape[0]) % multiple
    if pad == 0:
        return st
    return PackedState(packed_k=_pad_rows(st.packed_k, pad), rms=_pad_rows(st.rms, pad),
                       last_step=_pad_rows(st.last_step, pad, -1), cells=_pad_rows(st.cells, pad))


def grid_from_packed_state(bg: BrickGrid, st: PackedState) -> BrickGrid:
    """The packed masters written back into (a copy of) ``bg``, bit for
    bit."""
    nb, B = bg.n_bricks, st.basis_dim
    return dataclasses.replace(bg, density_bricks=st.packed_k[:nb, :, 0].clone(),
                               sh_bricks=st.packed_k[:nb, :, 1:1 + 3 * B].clone())


# ---------------------------------------------------------------------------
# The row-sharded state (module docstring)
# ---------------------------------------------------------------------------

class _Shard(NamedTuple):
    """Where this rank's rows lie: rows [lo, lo + per) of the padded
    state, local index i of global row lo + i, the spare row at local
    index per."""

    lo: int
    per: int
    group: object

    def local_index(self, rows: torch.Tensor) -> torch.Tensor:
        """Global rows -> local indices, the spare row where not owned."""
        owned = (rows >= self.lo) & (rows < self.lo + self.per)
        return torch.where(owned, rows - self.lo, self.per)

    def owns(self, row: int) -> bool:
        return self.lo <= row < self.lo + self.per

    def from_owners(self, vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """``vals`` [K, ...] (each rank's values for the slots of ``rows``,
        right only where it owns the row) -> the owners' values on every
        rank, exact: one ``all_gather`` and a pick per slot."""
        w = dist.get_world_size(self.group)
        parts = [torch.empty_like(vals) for _ in range(w)]
        dist.all_gather(parts, vals.contiguous(), group=self.group)
        owner = torch.div(rows, self.per, rounding_mode="floor")
        return torch.stack(parts)[owner, torch.arange(rows.shape[0], device=rows.device)]

    def rows_of(self, local: torch.Tensor):
        """The row fetch (global rows -> their values, from their owners)
        of a row-sharded array whose rows here are ``local``."""
        return lambda rows: self.from_owners(local[self.local_index(rows)], rows)


def _shard_of(mesh, cells: torch.Tensor) -> _Shard:
    r, w, group = axis_info(mesh, RAY_AXIS)
    n = cells.shape[0]
    if n % w:
        raise ValueError(f"a row-sharded state needs its {n} rows padded to a multiple of {w}")
    return _Shard(lo=r * (n // w), per=n // w, group=group)


def _step_shard(mesh, st, masters: torch.Tensor) -> Optional[_Shard]:
    """A step's shard of ``st`` (None without a mesh), checked."""
    if mesh is None:
        return None
    shard = None if st.cells is None else _shard_of(mesh, st.cells)
    if shard is None or masters.shape[0] != shard.per + 1:
        raise ValueError("mesh= needs a state from shard_state_rows (its rows and the whole cells)")
    return shard


def shard_state_rows(st, mesh):
    """The row-sharded state of a SparseBrickState or PackedState for this
    rank of ``mesh``'s "rays" axis: padded to a multiple of W rows, its
    float32 masters, RMSprop arrays and ``last_step`` cut to this rank's
    rows plus a spare row, and ``cells`` whole (a float32 copy of the
    masters when the state had none: what the host's one-process step
    marches)."""
    w = axis_info(mesh, RAY_AXIS)[1]
    packed = isinstance(st, PackedState)
    st = pad_packed_state_rows(st, w) if packed else pad_state_rows(st, w)
    if st.cells is not None:
        cells = st.cells.clone()
    else:
        cells = st.packed_k.clone() if packed else _pack(st.density_k, st.sh_k)
    shard = _shard_of(mesh, cells)

    def mine(x, fill=0):
        return _pad_rows(x[shard.lo: shard.lo + shard.per].clone(), 1, fill)

    if packed:
        return PackedState(packed_k=mine(st.packed_k), rms=mine(st.rms), last_step=mine(st.last_step, -1),
                           cells=cells)
    return SparseBrickState(density_k=mine(st.density_k), sh_k=mine(st.sh_k), cells=cells,
                            rms_density=mine(st.rms_density), rms_sh=mine(st.rms_sh),
                            last_step=mine(st.last_step, -1))


def gather_state_rows(st, mesh):
    """A row-sharded state (``shard_state_rows``) reassembled on every rank:
    the ranks' rows, spare rows dropped, gathered into the padded whole
    (``grid_from_*_state`` cuts the padding)."""
    group = _shard_of(mesh, st.cells).group

    def whole(x):
        return all_gather_rows(x[:-1], group)

    return type(st)(**{k: (v if k == "cells" else whole(v)) for k, v in st._asdict().items()})


def state_bytes(st) -> int:
    """The bytes of a state's float32 masters, RMSprop arrays and
    ``last_step`` on this rank (the march copy ``cells`` not counted)."""
    return sum(v.numel() * v.element_size() for k, v in st._asdict().items() if k != "cells" and v is not None)


# ---------------------------------------------------------------------------
# The shared skeleton: march, TV blocks, compaction, optimizers
# ---------------------------------------------------------------------------

def _check_regularizers(trainer, what: str) -> None:
    if trainer.lambda_l2_sh > 0 or trainer.lambda_tv_lumisphere > 0:
        raise ValueError(f"{what} does not support lambda_l2_sh / lambda_tv_lumisphere (full-grid "
                         "regularizers); use train_step_tiles_pallas")


def _psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def _march(trainer, bg, cells, rays, target, *, use_occupancy=False, n_chunks=None, flat_windows=None):
    """K3 + K4 with the flags: (mse, (grad_density [nb, 512], grad_sh [nb,
    512, 3B]), touched int32 [nb + 1], aux)."""
    if flat_windows is not None:
        from nerf_projects_tpu_torch.ops.kernels.flat_train import fused_grad_blocks_flat

        rgb, grads, touched, aux = fused_grad_blocks_flat(
            bg, rays, target, trainer.opts, kernel_arrays=cells, w_cap=flat_windows,
            beta_loss=trainer.lambda_beta, sparsity_loss=trainer.lambda_sparsity,
            grad_dtype=trainer.grad_block_dtype)
    else:
        rgb, grads, touched, aux = fused_grad_blocks(
            bg, rays, target, trainer.opts, beta_loss=trainer.lambda_beta,
            sparsity_loss=trainer.lambda_sparsity, use_occupancy=use_occupancy, kernel_arrays=cells,
            grad_dtype=trainer.grad_block_dtype, n_chunks=n_chunks)
    return torch.mean((rgb - target) ** 2), grads, touched, aux


def _tv_parts(trainer, bg: BrickGrid, density, sh, generator: torch.Generator):
    """The sampled TV in block form: [(kind "d" | "s", rows int64 [4w]
    (nb where there is no neighbour), vals [4w, 512, 1 | 3B])], the
    windows drawn from ``generator`` in the order density, SH (as the
    dense step draws them). ``density`` and ``sh`` fetch the masters' rows
    (brick rows [n] -> [n, 512, 1] and [n, 512, 3B]: ``x.__getitem__`` of
    a whole array, ``_Shard.rows_of`` of a row-sharded one); only the
    window's rows are read."""
    nb, parts = bg.n_bricks, []
    for kind, lam, frac, fetch, edge in (("d", trainer.lambda_tv, trainer.tv_sparsity, density, False),
                                         ("s", trainer.lambda_tv_sh, trainer.tv_sh_sparsity, sh, True)):
        if lam > 0:
            rows = sample_brick_window(generator, nb, max(int(frac * nb), 1)).to(bg.device)
            r4, v4 = tv_grad_brick_blocks(bg, fetch, rows, scale=lam, ignore_edge=edge)
            parts.append((kind, torch.where(r4 < 0, nb, r4).long(), v4))
    return parts


def pack_tv_blocks(tv_parts, B: int):
    """TV blocks -> packed-layout blocks [n, 512, CP] with their rows, so
    they join a packed accumulator in one add each. tv_parts as
    ``_tv_parts`` gives them (density vals [n, 512, 1], SH vals [n, 512,
    3B])."""
    rows_list, blocks_list = [], []
    for kind, r4, v4 in tv_parts:
        blk = torch.zeros(r4.shape[:1] + (CELLS, channels(B)), dtype=torch.float32, device=v4.device)
        if kind == "d":
            blk[..., 0] = v4[..., 0]
        else:
            blk[..., 1:1 + 3 * B] = v4
        rows_list.append(r4)
        blocks_list.append(blk)
    return rows_list, blocks_list


def _flags(touched: torch.Tensor, tv_parts, nb: int) -> torch.Tensor:
    """K4's flags with the TV rows set and the sentinel cleared."""
    flag = touched.clone()
    for _, r4, _v in tv_parts:
        flag.index_fill_(0, r4, 1)
    flag[nb].fill_(0)  # a fill on the device, not a copy of a host number
    return flag


def _compact(flag: torch.Tensor, K: int):
    """flag int32 [nb + 1] -> (slot [nb + 1] int64, each flagged row's
    place in the slot list, K where it has none; rows [K] int64, the
    flagged rows ascending, nb in the empty slots; overflow, the share of
    flagged rows beyond K, dropped). An exclusive cumsum gives the slots:
    no sort and no host sync."""
    nb = flag.shape[0] - 1
    f = flag.long()
    pos = torch.cumsum(f, 0) - f
    n_touched = pos[-1] + f[-1]
    live = (f == 1) & (pos < K)
    slot = torch.where(live, pos, K)
    rows = torch.full((K + 1,), nb, dtype=torch.long, device=flag.device)
    rows.scatter_(0, slot, torch.arange(nb + 1, device=flag.device))
    overflow = torch.clamp(n_touched - K, min=0) / torch.clamp(n_touched, min=1)
    return slot, rows[:K], overflow.float()


def _row_mask(bg: BrickGrid, rows: torch.Tensor) -> torch.Tensor:
    """The cell mask float32 [K, 512] of the slot list's rows (0 on the
    sentinel's)."""
    nb = bg.n_bricks
    return (bg.cell_mask[rows.clamp(max=nb - 1)] & (rows < nb)[:, None]).float()


def _finalize_rms(trainer, optim, data, grad, rms, decay, lr, minval=None):
    """The dense optimizer's recursion with the closed-form b^D lazy decay
    folded in (exact: the untouched steps have g == 0). Under per-visit
    RMSprop ``decay`` is b where this step's gradient is nonzero and rms
    stays where it is zero; the first visit bootstraps rms to g^2
    (optim_kernel.cu:21) in both modes."""
    if optim == "rmsprop":
        b = trainer.rms_beta
        rms_rec = decay * rms + (1.0 - b) * grad * grad
        if getattr(trainer, "rms_pervisit", False):
            rms = torch.where(grad == 0.0, rms, torch.where(rms == 0.0, grad * grad, rms_rec))
        else:
            rms = torch.where(rms == 0.0, grad * grad, rms_rec)
        new = data - lr * grad / (torch.sqrt(rms) + 1e-8)
    else:  # sgd
        new = data - lr * grad
    if minval is not None:
        new = torch.clamp(new, min=minval)
    return new, rms


def _lr_channels(trainer, step, x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., CP] scaled by lr_sigma on the density channel and lr_sh
    on the others (a new tensor; host numbers only)."""
    out = x * trainer.lr_sh_fn(step)
    out[..., 0] = x[..., 0] * trainer.lr_sigma_fn(step)
    return out


def _packed_update(trainer, data, g, rms_old, decay, step):
    """RMSprop or SGD on packed rows with per-channel learning rates and
    the density floor: (new, rms). ``decay``: the rms decay (b, or b^D per
    row), or None for per-visit RMSprop."""
    if trainer.sigma_optim == "rmsprop":
        b = trainer.rms_beta
        if decay is None:
            rms = torch.where(g == 0.0, rms_old, torch.where(rms_old == 0.0, g * g, b * rms_old + (1.0 - b) * g * g))
        else:
            rms = torch.where(rms_old == 0.0, g * g, decay * rms_old + (1.0 - b) * g * g)
        upd = _lr_channels(trainer, step, g / (torch.sqrt(rms) + 1e-8))
    else:
        rms = rms_old
        upd = _lr_channels(trainer, step, g)
    new = data - upd
    if trainer.density_minval > -1e8:
        new[..., 0] = torch.clamp(new[..., 0], min=trainer.density_minval)
    return new, rms


def _check_packed(trainer) -> None:
    _check_regularizers(trainer, "packed step")
    if trainer.sigma_optim != trainer.sh_optim:
        raise ValueError("packed step requires sigma_optim == sh_optim")


def _packed_cells(st: PackedState) -> torch.Tensor:
    return st.cells if st.cells is not None else st.packed_k


def _sparse_cells(st: SparseBrickState) -> torch.Tensor:
    return st.cells if st.cells is not None else _pack(st.density_k, st.sh_k)


def _stats(mse, aux, **extra) -> dict:
    return {"loss": mse, "mse": mse, "psnr": _psnr(mse), "window_miss": aux["window_miss"], **extra}


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

def train_step_tiles_sparse(
    trainer,
    bg: BrickGrid,
    st: SparseBrickState,
    rays: Rays,
    target: torch.Tensor,
    step: int,
    generator: torch.Generator,
    *,
    max_touched: Optional[int] = None,
    use_occupancy: bool = False,
    compact_chunks: Optional[int] = None,
    n_chunks: Optional[int] = None,
    mesh=None,
):
    """One row-sparse step on a SparseBrickState, with the lazy b^D
    optimizer (per visit under ``trainer.rms_pervisit``). ``bg`` supplies
    geometry only (``tile_march.geometry_only`` is fine); the data live
    in ``st``, whose touched rows are updated in place. Returns (st,
    stats).

    ``max_touched``: the slot list's length, a bound on the bricks a step
    touches (default the TPU plan's contribution count, T * C * 8 corner
    rows plus the TV's, capped at nb + 1). Rows beyond it are dropped and
    reported in stats["touched_overflow"] (the share of flagged rows
    dropped). ``compact_chunks`` is a TPU knob, accepted and ignored.
    ``mesh``: ``st`` is row-sharded over its "rays" axis
    (``shard_state_rows``; module docstring)."""
    del compact_chunks
    _check_regularizers(trainer, "sparse step")
    nb, B = bg.n_bricks, st.basis_dim
    shard = _step_shard(mesh, st, st.density_k)
    mse, (gd, gsh), touched, aux = _march(trainer, bg, _sparse_cells(st), rays, target,
                                          use_occupancy=use_occupancy, n_chunks=n_chunks)
    fetch = (lambda x: x.__getitem__) if shard is None else shard.rows_of
    tv = _tv_parts(trainer, bg, fetch(st.density_k[..., None]), fetch(st.sh_k), generator)
    if max_touched is None:
        C = n_chunks or (active_chunk_bound(bg, trainer.opts.step_size) if use_occupancy
                         else default_chunks_for(bg, trainer.opts))
        max_touched = min(rays.origins.shape[0] * C * 8 + sum(r4.shape[0] for _, r4, _v in tv), nb + 1)
    K = int(max_touched)
    slot, rows, overflow = _compact(_flags(touched, tv, nb), K)

    rc = rows.clamp(max=nb - 1)
    acc_d = torch.zeros((K + 1, CELLS), device=gd.device)
    acc_sh = torch.zeros((K + 1, CELLS, 3 * B), device=gd.device)
    acc_d[:K] = gd[rc]
    acc_sh[:K] = gsh[rc]
    for kind, r4, v4 in tv:
        if kind == "d":
            acc_d.index_add_(0, slot[r4], v4[..., 0])
        else:
            acc_sh.index_add_(0, slot[r4], v4)
    m = _row_mask(bg, rows)
    acc_d, acc_sh = acc_d[:K] * m, acc_sh[:K] * m[..., None]

    # the slots' rows in the state's arrays (sharded: local, the spare row
    # where another rank owns the row)
    idx = rows if shard is None else shard.local_index(rows)
    b = trainer.rms_beta
    if getattr(trainer, "rms_pervisit", False):
        decay_d = torch.where(acc_d != 0.0, b, 1.0)
        decay_s = torch.where(acc_sh != 0.0, b, 1.0)
    else:
        delta = (step - st.last_step[idx]).float()
        rms_on = trainer.sigma_optim == "rmsprop" or trainer.sh_optim == "rmsprop"
        decay = torch.pow(b, delta) if rms_on else torch.ones_like(delta)
        decay_d, decay_s = decay[:, None], decay[:, None, None]
    new_d, rms_d = _finalize_rms(trainer, trainer.sigma_optim, st.density_k[idx], acc_d,
                                 st.rms_density[idx].float(), decay_d, trainer.lr_sigma_fn(step),
                                 minval=trainer.density_minval)
    new_d = new_d * m
    new_s, rms_s = _finalize_rms(trainer, trainer.sh_optim, st.sh_k[idx], acc_sh, st.rms_sh[idx].float(),
                                 decay_s, trainer.lr_sh_fn(step))

    # scatter back (the slot list's rows are unique but for the sentinel,
    # whose every slot writes the same zeros, and the spare row)
    st.density_k[idx] = new_d
    st.sh_k[idx] = new_s
    if shard is not None:
        st.cells[rows] = shard.from_owners(_pack(new_d, new_s, st.cells.dtype), rows)
    elif st.cells is not None:
        st.cells[rows] = _pack(new_d, new_s, torch.bfloat16)
    st.rms_density[idx] = rms_d.to(st.rms_density.dtype)
    st.rms_sh[idx] = rms_s.to(st.rms_sh.dtype)
    st.last_step.index_fill_(0, idx, int(step))
    if shard is None or shard.owns(nb):
        at = nb if shard is None else nb - shard.lo
        for x in (st.density_k, st.sh_k, st.rms_density, st.rms_sh):
            x[at].fill_(0.0)
        st.last_step[at].fill_(-1)
    return st, _stats(mse, aux, touched_overflow=overflow)


def tile_segment_reduce(gp_blocks: torch.Tensor, rows: torch.Tensor, nb: int, k_tile: int):
    """Per-tile segment reduction of gradient blocks (counterpart of the
    TPU's MXU pre-reduction): gp_blocks [T, C, 8, ...], rows [T, C, 8]
    brick rows (nb = none) -> (tile_rows [T, k_tile] int32, each tile's
    distinct rows ascending, nb in empty slots; tile_acc [T, k_tile, ...]
    float32, the blocks summed onto them; dropped, the distinct rows
    beyond k_tile over all tiles, whose blocks are lost). The port's
    steps have no use for it: K4 sums each run of a corner's samples
    before it adds, so there are no per-window blocks to pre-reduce."""
    T, C = rows.shape[:2]
    M = C * 8
    r2 = rows.reshape(T, M).long()
    srt, _ = torch.sort(r2, dim=1)
    first = torch.cat([torch.ones((T, 1), dtype=torch.bool, device=rows.device), srt[:, 1:] != srt[:, :-1]], 1)
    first &= srt != nb
    fi = first.long()
    pos = torch.cumsum(fi, 1) - fi
    nuniq = pos[:, -1] + fi[:, -1]
    dropped = torch.clamp(nuniq - k_tile, min=0).sum()
    slot_sorted = torch.where(first & (pos < k_tile), pos, k_tile)
    tile_rows = torch.full((T, k_tile + 1), nb, dtype=torch.long, device=rows.device)
    tile_rows.scatter_(1, slot_sorted, srt)
    tile_rows = tile_rows[:, :k_tile].contiguous()
    ss = torch.clamp(torch.searchsorted(tile_rows, r2), max=k_tile - 1)
    valid = (torch.gather(tile_rows, 1, ss) == r2) & (r2 != nb)
    flat = gp_blocks.reshape(T, M, -1).float()
    acc = torch.zeros((T, k_tile + 1, flat.shape[-1]), device=flat.device)
    acc.scatter_add_(1, torch.where(valid, ss, k_tile)[..., None].expand(-1, -1, flat.shape[-1]), flat)
    return (tile_rows.to(torch.int32), acc[:, :k_tile].reshape((T, k_tile) + tuple(gp_blocks.shape[3:])),
            dropped)


def _tile_bricks(bg: BrickGrid, rays: Rays, opts, use_occupancy: bool):
    """The plain march's touched bricks, bool [T, nb]: the bricks each
    tile's live samples read a corner from."""
    from nerf_projects_tpu_torch.ops.kernels.tile_march import build_kernel_arrays

    cells, pack, basis, max_steps = march_inputs(bg, rays, opts, use_occupancy=use_occupancy,
                                                 kernel_arrays=build_kernel_arrays(bg, torch.float32))
    out = []
    for t in range(pack.shape[0]):
        _, c = march_reference(cells, bg.brick_links, bg.reso, pack[t:t + 1], basis[t:t + 1],
                               max_steps=max_steps, color_mode=opts.color_mode, sigma_thresh=opts.sigma_thresh,
                               stop_thresh=opts.stop_thresh, counts=True)
        out.append(c["touched"])
    return torch.stack(out)


def required_tile_rows(bg: BrickGrid, rays: Rays, opts, *, use_occupancy: bool = False,
                       compact_chunks: Optional[int] = None, multiple: int = 16) -> int:
    """Host-side helper: the most distinct bricks any tile's samples read,
    rounded up to ``multiple`` (the k_tile of ``tile_segment_reduce``).
    Runs the plain march tile by tile: keep it to small batches."""
    del compact_chunks
    need = max(1, int(_tile_bricks(bg, rays, opts, use_occupancy).sum(dim=1).max()))
    return -(-need // multiple) * multiple


def required_touched_rows(bg: BrickGrid, rays: Rays, opts, *, tv_rows: int = 0, use_occupancy: bool = True,
                          multiple: int = 256) -> int:
    """Host-side count of the distinct bricks this batch's samples read
    (the plain march's, a superset of those K4 adds into), plus
    ``tv_rows`` (4 (w_density + w_sh): a sampled brick and its 3 axis
    neighbours), rounded up to ``multiple``: the tight ``max_touched``
    when the same rays are marched every step, or a sizing probe."""
    from nerf_projects_tpu_torch.ops.kernels.tile_march import build_kernel_arrays

    cells, pack, basis, max_steps = march_inputs(bg, rays, opts, use_occupancy=use_occupancy,
                                                 kernel_arrays=build_kernel_arrays(bg))
    _, c = march_reference(cells, bg.brick_links, bg.reso, pack, basis, max_steps=max_steps,
                           color_mode=opts.color_mode, sigma_thresh=opts.sigma_thresh, stop_thresh=opts.stop_thresh,
                           counts=True, skip_empty=True)
    need = int(c["touched"].sum()) + int(tv_rows)
    return -(-need // multiple) * multiple


def _dense_packed_acc(st: PackedState, gd, gsh, tv) -> torch.Tensor:
    """The dense packed accumulator [nb + 1, 512, CP]: K4's gradients and
    the TV blocks."""
    nb = gd.shape[0]
    B = st.basis_dim
    acc = torch.zeros(st.packed_k.shape, dtype=torch.float32, device=gd.device)
    acc[:nb, :, 0] = gd
    acc[:nb, :, 1:1 + 3 * B] = gsh
    for r4, blk in zip(*pack_tv_blocks(tv, B)):
        acc.index_add_(0, r4, blk)
    return acc


def _dense_mask(cell_mask: torch.Tensor) -> torch.Tensor:
    """The cell mask float32 [nb + 1, 512, 1], the sentinel's row 0."""
    return _append_row(cell_mask.float())[..., None]


def train_step_tiles_packed(
    trainer,
    bg: BrickGrid,
    st: PackedState,
    rays: Rays,
    target: torch.Tensor,
    step: int,
    generator: torch.Generator,
    *,
    use_occupancy: bool = False,
    compact_chunks: Optional[int] = None,
    n_chunks: Optional[int] = None,
    wps: int = 1,
    skip_empty: bool = True,
):
    """The dense update on the packed state: ``train_step_tiles_pallas``'s
    semantics (K3 + K4, sampled TV, RMSprop or SGD over every cell, the
    lazy-free per-step decay) with the state in the march's layout.
    Requires sigma_optim == sh_optim. Returns (new state, stats);
    ``last_step`` is carried unchanged. ``compact_chunks``, ``wps`` and
    ``skip_empty`` are TPU knobs, accepted and ignored."""
    del compact_chunks, wps, skip_empty
    _check_packed(trainer)
    nb, B = bg.n_bricks, st.basis_dim
    mse, (gd, gsh), _touched, aux = _march(trainer, bg, _packed_cells(st), rays, target,
                                           use_occupancy=use_occupancy, n_chunks=n_chunks)
    tv = _tv_parts(trainer, bg, st.packed_k[..., :1].__getitem__, st.packed_k[..., 1:1 + 3 * B].__getitem__,
                   generator)
    m = _dense_mask(bg.cell_mask)
    g = _dense_packed_acc(st, gd, gsh, tv) * m
    pervisit = getattr(trainer, "rms_pervisit", False)
    new, rms = _packed_update(trainer, st.packed_k, g, st.rms.float(), None if pervisit else trainer.rms_beta, step)
    new = new * m
    return (PackedState(packed_k=new, rms=rms.to(st.rms.dtype), last_step=st.last_step,
                        cells=None if st.cells is None else new.to(torch.bfloat16)),
            _stats(mse, aux))


train_step_tiles_packed_jit = train_step_tiles_packed


def _dense_sweep(trainer, cell_mask: torch.Tensor, st: PackedState, acc: torch.Tensor, flag: torch.Tensor,
                 step: int) -> PackedState:
    """The dense-sweep optimizer (``train_step_tiles_packed_touched``'s
    ``dense_optim``): RMSprop or SGD over the whole state from the dense
    accumulator, ``where(g == 0)`` keeping the elements without a
    gradient bit-identical (the per-visit semantics). The reference's
    always-dense optimizer sweep (optim_kernel.cu:20-27) at the same
    whole-state cost."""
    nb = cell_mask.shape[0]
    g = acc * _dense_mask(cell_mask)
    pk = st.packed_k
    new, rms = _packed_update(trainer, pk, g, st.rms.float(), None, step)
    new = torch.where(g == 0.0, pk, new)
    last = torch.where(flag == 1, int(step), st.last_step)
    last[nb].fill_(-1)
    return PackedState(packed_k=new, rms=rms.to(st.rms.dtype), last_step=last,
                       cells=None if st.cells is None else new.to(torch.bfloat16))


def dense_sweep_apply(trainer, bg: BrickGrid, st: PackedState, acc: torch.Tensor, flag: torch.Tensor,
                      step: int) -> PackedState:
    """The second half of ``dense_optim="defer"``: the dense sweep of
    ``st`` from the accumulator and flags that the touched step returned
    in stats ("dense_acc", "touched_flag"). Bit-identical to the
    ``dense_optim=True`` step."""
    return _dense_sweep(trainer, bg.cell_mask, st, acc, flag, step)


dense_sweep_apply_jit = dense_sweep_apply


def train_step_tiles_packed_touched(
    trainer,
    bg: BrickGrid,
    st: PackedState,
    rays: Rays,
    target: torch.Tensor,
    step: int,
    generator: torch.Generator,
    *,
    max_touched: int = 12288,
    use_occupancy: bool = False,
    compact_chunks: Optional[int] = None,
    n_chunks: Optional[int] = None,
    wps: int = 1,
    tile_rows: Optional[int] = None,
    skip_empty: bool = True,
    flat_windows: Optional[int] = None,
    dense_optim=False,
    mesh=None,
):
    """The touched-row step on the packed state, the fast sparse path:
    ``train_step_tiles_packed``'s math (K3 + K4, sampled TV, RMSprop or
    SGD, lazy-exact: an untouched row's update is zero and its rms decay
    b^D is applied in closed form at its next touch), with the optimizer
    reading and writing only the rows the step touched, in place. Returns
    (st, stats).

    The touched rows are K4's flags and the TV window's rows, compacted
    into a slot list of ``max_touched`` rows (flag -> exclusive cumsum ->
    slot: no sort, no host sync); rows beyond it are dropped and reported
    in stats["touched_overflow"], the share of flagged rows dropped.
    ``step`` is the true global step (a host number; the lazy decay keys
    on it).

    ``flat_windows``: march through ``flat_train.fused_grad_blocks_flat``
    (the occupancy clip on; the TPU's window capacity, accepted).
    ``tile_rows``, ``wps``, ``compact_chunks`` and ``skip_empty`` are TPU
    schedule knobs, accepted and ignored (stats["dropped_tile_rows"] 0).

    ``dense_optim``: no compaction: the gradients go into a dense [nb +
    1]-row accumulator and the whole state is swept with ``where(g ==
    0)`` (``_dense_sweep``), exact under per-visit RMSprop or SGD (the
    b^D lazy decay needs per-row deltas, so literal RMSprop raises).
    ``dense_optim="defer"`` returns that accumulator and the flags in
    stats ("dense_acc", "touched_flag") with the state unchanged, for
    ``dense_sweep_apply``: bit-identical to ``dense_optim=True``.

    ``mesh``: ``st`` is row-sharded over its "rays" axis
    (``shard_state_rows``; module docstring); not with ``dense_optim``."""
    del compact_chunks, wps, skip_empty
    with span("plenoxels.step"):
        _check_packed(trainer)
        if st.last_step is None:
            raise ValueError("touched step needs PackedState.last_step (packed_state_from_grid provides it)")
        if flat_windows is not None and tile_rows is not None:
            raise ValueError("flat_windows: tile_rows pre-reduction does not apply (the flat stream has no per-tile "
                             "block structure)")
        nb, B = bg.n_bricks, st.basis_dim
        K = int(max_touched)
        shard = _step_shard(mesh, st, st.packed_k)
        if shard is not None and dense_optim:
            raise ValueError("dense_optim sweeps the whole state; a row-sharded state takes the touched rows")
        with span("plenoxels.march", device=True):
            mse, (gd, gsh), touched, aux = _march(trainer, bg, _packed_cells(st), rays, target,
                                                  use_occupancy=use_occupancy, n_chunks=n_chunks,
                                                  flat_windows=flat_windows)
        fetch = (lambda x: x.__getitem__) if shard is None else shard.rows_of
        tv = _tv_parts(trainer, bg, fetch(st.packed_k[..., :1]), fetch(st.packed_k[..., 1:1 + 3 * B]), generator)
        stats = _stats(mse, aux, touched_overflow=torch.zeros((), device=mse.device),
                       dropped_tile_rows=torch.zeros((), dtype=torch.int32, device=mse.device),
                       dropped_active_chunks=aux["dropped_active_chunks"])

        if dense_optim:
            if tile_rows is not None:
                raise ValueError("dense_optim: tile_rows pre-reduction does not apply")
            if trainer.sigma_optim == "rmsprop" and not getattr(trainer, "rms_pervisit", False):
                raise ValueError("dense_optim requires rms_pervisit RMSprop (or SGD): the beta^delta lazy decay "
                                 "needs per-row deltas")
            with span("plenoxels.accumulate", device=True):
                acc = _dense_packed_acc(st, gd, gsh, tv)
                flag = touched.clone()
                for _, r4, _v in tv:
                    flag.index_fill_(0, r4, 1)
                count_device("plenoxels.rows_flagged", flag.sum)
            if dense_optim == "defer":
                stats["dense_acc"] = acc
                stats["touched_flag"] = flag
                return st, stats
            with span("plenoxels.sweep", device=True):
                count("plenoxels.rows_swept", nb + 1)
                return _dense_sweep(trainer, bg.cell_mask, st, acc, flag, step), stats

        slot, rows, stats["touched_overflow"] = _compact(_flags(touched, tv, nb), K)
        rc = rows.clamp(max=nb - 1)
        acc = torch.zeros((K + 1, CELLS, channels(B)), device=gd.device)
        acc[:K, :, 0] = gd[rc]
        acc[:K, :, 1:1 + 3 * B] = gsh[rc]
        for r4, blk in zip(*pack_tv_blocks(tv, B)):
            acc.index_add_(0, slot[r4], blk)
        m = _row_mask(bg, rows)[..., None]
        g = acc[:K] * m

        idx = rows if shard is None else shard.local_index(rows)  # as in train_step_tiles_sparse
        pervisit = getattr(trainer, "rms_pervisit", False)
        decay = None if pervisit else torch.pow(trainer.rms_beta, (step - st.last_step[idx]).float())[:, None, None]
        new, rms = _packed_update(trainer, st.packed_k[idx], g, st.rms[idx].float(), decay, step)
        new = new * m  # the sentinel's slots stay exactly zero

        st.packed_k[idx] = new
        st.rms[idx] = rms.to(st.rms.dtype)
        if shard is not None:
            st.cells[rows] = shard.from_owners(new.to(st.cells.dtype), rows)
        elif st.cells is not None:
            st.cells[rows] = new.to(torch.bfloat16)
        st.last_step.index_fill_(0, idx, int(step))
        if shard is None or shard.owns(nb):
            st.last_step[nb if shard is None else nb - shard.lo].fill_(-1)
        return st, stats


train_step_tiles_packed_touched_jit = train_step_tiles_packed_touched


def train_step_tiles_dense_k(
    trainer,
    bg: BrickGrid,
    st: SparseBrickState,
    rays: Rays,
    target: torch.Tensor,
    step: int,
    generator: torch.Generator,
    *,
    use_occupancy: bool = False,
    compact_chunks: Optional[int] = None,
    n_chunks: Optional[int] = None,
):
    """The dense update on a SparseBrickState: ``train_step_tiles_pallas``'s
    semantics (K3 + K4, sampled TV, the optimizer over every cell) with
    the masters in the state's layout. JAX's version marches the float32
    masters (a state from ``sparse_state_from_grid(bg,
    shared_kernel_arrays=True)``); so does this on the host, while on the
    card it marches the state's bf16 copy (module docstring). Returns (new
    state, stats); ``last_step`` is carried unchanged."""
    del compact_chunks
    _check_regularizers(trainer, "kernel-layout step")
    nb = bg.n_bricks
    mse, (gd, gsh), _touched, aux = _march(trainer, bg, _sparse_cells(st), rays, target,
                                           use_occupancy=use_occupancy, n_chunks=n_chunks)
    acc_d = _append_row(gd)
    acc_sh = _append_row(gsh)
    for kind, r4, v4 in _tv_parts(trainer, bg, st.density_k[..., None].__getitem__, st.sh_k.__getitem__, generator):
        if kind == "d":
            acc_d.index_add_(0, r4, v4[..., 0])
        else:
            acc_sh.index_add_(0, r4, v4)
    md = _dense_mask(bg.cell_mask)[..., 0]
    msh = md[..., None]
    new_d, rms_d = _finalize_rms(trainer, trainer.sigma_optim, st.density_k, acc_d * md, st.rms_density.float(),
                                 trainer.rms_beta, trainer.lr_sigma_fn(step), minval=trainer.density_minval)
    new_d = new_d * md
    new_s, rms_s = _finalize_rms(trainer, trainer.sh_optim, st.sh_k, acc_sh * msh, st.rms_sh.float(),
                                 trainer.rms_beta, trainer.lr_sh_fn(step))
    new_s = new_s * msh
    new_st = SparseBrickState(
        density_k=new_d, sh_k=new_s, cells=None if st.cells is None else _pack(new_d, new_s, torch.bfloat16),
        rms_density=rms_d.to(st.rms_density.dtype), rms_sh=rms_s.to(st.rms_sh.dtype), last_step=st.last_step)
    return new_st, _stats(mse, aux)


train_step_tiles_dense_k_jit = train_step_tiles_dense_k
train_step_tiles_sparse_jit = train_step_tiles_sparse
