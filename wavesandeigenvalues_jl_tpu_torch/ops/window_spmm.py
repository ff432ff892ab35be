"""CSR SpMM for large operators: the port's counterpart of kernels K4 and
K5, and of their wrappers ``WindowSpmm`` and ``ChunkSpmm``.

:func:`window_spmm` computes ``Y[i] = Σ_{k ∈ row i} vals[k]·X[cols[k]]``
as one launch of the hand-written CUDA kernel ``csrc/window_spmm.cu``.  It
replaces both windowed Pallas TPU kernels of the JAX package:
``ops/window_spmm.py :: _make_kernel`` (K4, slot-padded 128×128 blocks) and
``ops/window_spmm2.py :: _build_call`` (K5, compact 8×128 blocks chunked
by window column).  Like K4, it streams X once through a window that
slides down the Cuthill–McKee-ordered band, here a ring of X rows in each
SM's shared memory; unlike K4 and K5 it has no window limit: a nonzero
outside its tile's window is read from global memory, so an operator whose
band exceeds the ring, which K4 and K5 refuse, gets the right Y.

* :func:`plan` is the kernel's launch for one structure, panel width and
  card: column chunks, row ranges, each tile's stages of the ring, each
  nonzero's ring slot and the count of nonzeros outside their window.  It
  runs on the host, once per structure (:class:`WindowSpmm` builds it in
  its constructor), and holds the structure's tensors: the kernel runs a
  plan only on the very ``indptr`` and ``cols`` it was made from.
* :func:`window_spmm_ref` is its plain PyTorch version: a gather of X rows
  times the values, then ``index_add_`` into the rows.
* :func:`window_spmm` takes the plain version only for tensors that lie on
  the CPU; for CUDA tensors it launches the kernel by its plan or
  raises.  It counts its launches and its CPU calls in ``utils.timing``'s
  counters ``window_spmm.launches`` and ``window_spmm.twin_calls``.
* :class:`WindowSpmm` holds a reordered CSR operator on the device (the
  counterpart of ``WindowSpmm`` and ``ChunkSpmm``), with ``chain`` for m
  normalized applies (the counterpart of ``chain_fn``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..utils import timing
from . import cuda_build
from .dense_gmres import sm_count
from .sparse import CSR

#: the kernel takes panels whose width is a multiple of this (two complex
#: columns a lane, 16-byte loads and stores)
COL_MULTIPLE = 4
#: the kernel's layout (``csrc/window_spmm.cu`` holds the same numbers and
#: :func:`build` checks them): complex columns of a block's chunk, rows of
#: a tile, X rows of a ring stage, stages of the ring, consumer warps
CHUNK, TILE_ROWS, STAGE_ROWS, RING_STAGES, CONSUMER_WARPS = 16, 128, 32, 40, 16
RING_ROWS = STAGE_ROWS * RING_STAGES
#: rows a consumer warp takes at a time (four lanes a row)
ROWS_A_WARP = TILE_ROWS // CONSUMER_WARPS


class WindowLaunch(NamedTuple):
    """The launch of the kernel for one CSR structure at panel width ``r``
    on a card of ``n_sm`` SMs.

    ``chunks`` × ``ranges`` blocks: a block owns a chunk of CHUNK complex
    columns (the last one ragged) and range q of the row tiles, tiles
    [q·n_tiles // ranges, (q + 1)·n_tiles // ranges).  Even ranges walk
    their tiles forward, odd ranges backward, so that two neighbours stage
    the rows of X they share at the same time.  A range streams X stages
    ``streams[q] = (first, count)``: stage first + i (first − i walking
    backward) for i < count.  ``tiles[t] = (far, near)``: the last stream
    index tile t reads (−1 without nonzeros) and the first one it or a
    later tile of the walk still reads.  ``window[t]`` = the first and end
    row of X that tile t finds in the ring; ``slots[k]`` = the ring row of
    nonzero k, col % RING_ROWS, or −1 − col outside its tile's window.
    ``order[t·TILE_ROWS + c]``: the row that consumer warp c // ROWS_A_WARP
    takes as its row c % ROWS_A_WARP of tile t (−1 past the last row): the
    tile's rows sorted by their nonzeros, dealt out in groups of
    ROWS_A_WARP, group g to warp (g − t) mod CONSUMER_WARPS, so that a
    warp's rows have alike lengths and no warp takes the longest rows of
    every tile.  ``staged_rows``: X rows the streams of one chunk stage.
    ``indptr`` and ``cols``: the structure the plan was made from (int32
    tensors, moved with the plan)."""
    r: int
    n_sm: int
    chunks: int
    ranges: int
    window: np.ndarray
    tiles: torch.Tensor
    streams: torch.Tensor
    slots: torch.Tensor
    order: torch.Tensor
    out_of_window: int
    staged_rows: int
    indptr: torch.Tensor
    cols: torch.Tensor

    @property
    def blocks(self) -> int:
        return self.chunks * self.ranges

    def to(self, device) -> "WindowLaunch":
        return self._replace(**{k: getattr(self, k).to(device) for k in (
            "tiles", "streams", "slots", "order", "indptr", "cols")})

    def made_for(self, indptr: torch.Tensor, cols: torch.Tensor,
                 r: int) -> bool:
        """Whether this plan is the one of (indptr, cols) at width r: the
        same tensors (not only the same sizes), checked without a host
        sync."""
        return (self.r == r and
                indptr.data_ptr() == self.indptr.data_ptr() and
                indptr.numel() == self.indptr.numel() and
                cols.data_ptr() == self.cols.data_ptr() and
                cols.numel() == self.cols.numel() and
                indptr.device == self.indptr.device)


def plan(indptr, cols, r: int, n_sm: int) -> WindowLaunch:
    """The kernel's launch (:class:`WindowLaunch`) for the CSR structure
    (``indptr``, ``cols``: int32 tensors, which the plan keeps, or host
    arrays, which it copies) at panel width r on n_sm SMs.

    One block an SM: ranges = n_sm // chunks (at least 1, at most the
    tiles).  Walking forward, tile t's window starts at the stage of lo_t,
    the least column of tiles t, t + 1, ... of its range, so it never moves
    back; walking backward, it ends at the stage of the largest column of
    tiles ..., t − 1, t.  A window is RING_STAGES stages; a tile waits for
    the stages from its window's start to its farthest column in it."""
    structure = [t if isinstance(t, torch.Tensor) and t.dtype == torch.int32
                 else torch.from_numpy(np.asarray(t).astype(np.int32))
                 for t in (indptr, cols)]
    indptr, cols = (np.asarray(t.cpu(), np.int64) for t in structure)
    if r < COL_MULTIPLE or r % COL_MULTIPLE:
        raise ValueError(f"the kernel takes r a multiple of {COL_MULTIPLE}, "
                         f"got r={r}")
    n = len(indptr) - 1
    n_tiles = -(-n // TILE_ROWS)
    chunks = -(-r // CHUNK)
    ranges = max(1, min(n_sm // chunks, n_tiles))
    edges = indptr[np.minimum(np.arange(n_tiles + 1) * TILE_ROWS, n)]
    has = edges[1:] > edges[:-1]
    lo_col = np.zeros(n_tiles, np.int64)
    hi_col = np.zeros(n_tiles, np.int64)
    if has.any():
        starts = edges[:-1][has]
        lo_col[has] = np.minimum.reduceat(cols, starts)
        hi_col[has] = np.maximum.reduceat(cols, starts)
    window = np.zeros((n_tiles, 2), np.int64)
    tiles = np.zeros((n_tiles, 2), np.int64)
    streams = np.zeros((ranges, 2), np.int64)
    for q in range(ranges):
        t0, t1 = q * n_tiles // ranges, (q + 1) * n_tiles // ranges
        h = has[t0:t1]
        tiles[t0:t1] = (-1, 0)
        if not h.any():
            continue
        nz = np.flatnonzero(h)
        if q % 2 == 0:
            # suffix minimum of the least columns; tiles past the last
            # with nonzeros keep its window
            lo = np.where(h, lo_col[t0:t1], np.iinfo(np.int64).max)
            lo = np.minimum.accumulate(lo[::-1])[::-1]
            lo[nz[-1] + 1:] = lo[nz[-1]]
            near = lo // STAGE_ROWS
            far = np.minimum(hi_col[t0:t1] // STAGE_ROWS,
                             near + RING_STAGES - 1)
            first = near[0]
            streams[q] = first, far[h].max() - first + 1
            tiles[t0:t1, 0] = np.where(h, far - first, -1)
            tiles[t0:t1, 1] = near - first
            window[t0:t1] = np.stack(
                [near, near + RING_STAGES], 1) * STAGE_ROWS
        else:
            # prefix maximum of the largest columns, walked from the end;
            # tiles before the first with nonzeros keep its window
            hi = np.maximum.accumulate(np.where(h, hi_col[t0:t1], -1))
            hi[:nz[0]] = hi[nz[0]]
            top = hi // STAGE_ROWS
            far = np.maximum(lo_col[t0:t1] // STAGE_ROWS,
                             top - RING_STAGES + 1)
            first = top[-1]
            streams[q] = first, first - far[h].min() + 1
            tiles[t0:t1, 0] = np.where(h, first - far, -1)
            tiles[t0:t1, 1] = first - top
            window[t0:t1] = np.stack(
                [top - RING_STAGES + 1, top + 1], 1) * STAGE_ROWS
    tile_of = np.repeat(np.arange(n) // TILE_ROWS, np.diff(indptr))
    inside = (cols >= window[tile_of, 0]) & (cols < window[tile_of, 1])
    slots = np.where(inside, cols % RING_ROWS, -1 - cols)
    # each tile's rows by their nonzeros (rows past n last), dealt out
    rows = np.arange(n_tiles * TILE_ROWS)
    length = np.full(rows.size, -1)
    length[:n] = np.diff(indptr)
    by_length = np.argsort(-length.reshape(n_tiles, TILE_ROWS), axis=1,
                           kind="stable") + rows[::TILE_ROWS, None]
    groups = by_length.reshape(n_tiles, CONSUMER_WARPS, ROWS_A_WARP)
    deal = (np.arange(CONSUMER_WARPS)[None, :]
            + np.arange(n_tiles)[:, None]) % CONSUMER_WARPS
    order = np.take_along_axis(groups, deal[:, :, None], axis=1).reshape(-1)
    order[order >= n] = -1
    return WindowLaunch(
        r, n_sm, chunks, ranges, window,
        torch.from_numpy(tiles.astype(np.int32)),
        torch.from_numpy(streams.astype(np.int32)),
        torch.from_numpy(slots.astype(np.int32)),
        torch.from_numpy(order.astype(np.int32)),
        int((~inside).sum()), int(streams[:, 1].sum()) * STAGE_ROWS,
        *structure)


def window_spmm_ref(indptr: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch CSR SpMM (same contract as the kernel): indptr
    [n + 1], cols [nnz], vals [nnz], X [n_cols, r] -> Y [n, r]."""
    n = indptr.numel() - 1
    rows = torch.repeat_interleave(
        torch.arange(n, device=X.device), indptr.diff().long())
    prod = vals[:, None] * X[cols.long()]                   # [nnz, r]
    Y = X.new_zeros(n, X.shape[1])
    torch.view_as_real(Y).index_add_(0, rows, torch.view_as_real(prod))
    return Y


@functools.cache
def build() -> dict:
    """Compile ``csrc/window_spmm.cu`` (once per source hash) and load it:
    {"lib", "path", "seconds", "log"} (see :func:`.cuda_build.load`); the
    kernel's layout must be this module's."""
    info = cuda_build.load("window_spmm")
    lib = bind(info["lib"])
    layout = (ctypes.c_int * 5)()
    lib.window_spmm_layout(layout)
    ours = (CHUNK, TILE_ROWS, STAGE_ROWS, RING_STAGES, CONSUMER_WARPS)
    if tuple(layout) != ours:
        raise RuntimeError(f"csrc/window_spmm.cu has layout {tuple(layout)}"
                           f", ops/window_spmm.py {ours}")
    return info


def bind(lib):
    """Argument types of the kernel's C entry point; returns ``lib``."""
    lib.window_spmm_c64.argtypes = [ctypes.c_void_p] * 8 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.window_spmm_c64.restype = ctypes.c_int
    return lib


def _check(indptr, cols, vals, X):
    if vals.dtype != torch.complex64 or X.dtype != torch.complex64:
        raise TypeError(f"window_spmm takes complex64, got {vals.dtype} and "
                        f"{X.dtype}")
    if indptr.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError(f"indptr and cols must be int32, got {indptr.dtype} "
                        f"and {cols.dtype}")
    if not (indptr.device == cols.device == vals.device == X.device):
        raise ValueError(f"indptr on {indptr.device}, cols on {cols.device}, "
                         f"vals on {vals.device}, X on {X.device}")
    if indptr.dim() != 1 or indptr.numel() < 2 or cols.dim() != 1 or \
            vals.shape != cols.shape or X.dim() != 2:
        raise ValueError(
            f"shapes {tuple(indptr.shape)}, {tuple(cols.shape)}, "
            f"{tuple(vals.shape)}, {tuple(X.shape)}: expected [n + 1] with "
            "n ≥ 1, [nnz], [nnz] and [n_cols, r]")
    if not all(t.is_contiguous() for t in (indptr, cols, vals, X)):
        raise ValueError("window_spmm takes contiguous tensors")


def launch(lib, vals: torch.Tensor, X: torch.Tensor,
           lp: WindowLaunch) -> torch.Tensor:
    """One launch of the kernel in ``lib`` on CUDA tensors by the launch
    plan ``lp`` (on X's device, for X's width; checked by the caller),
    which may be another card's, on the plan's structure; returns Y."""
    n, (n_cols, r) = lp.indptr.numel() - 1, X.shape
    Y = X.new_empty(n, r)
    code = lib.window_spmm_c64(
        lp.indptr.data_ptr(), lp.slots.data_ptr(), vals.data_ptr(),
        lp.tiles.data_ptr(), lp.streams.data_ptr(), lp.order.data_ptr(),
        X.data_ptr(), Y.data_ptr(), n, n_cols, r, lp.ranges,
        torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, "window_spmm", code)
    return Y


def window_spmm(indptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                X: torch.Tensor, lp: WindowLaunch | None = None
                ) -> torch.Tensor:
    """Y [n, r] = the CSR product.  CPU tensors: plain version; CUDA
    tensors: the kernel (r a multiple of 4) by ``lp``, the launch plan
    (:func:`plan`) made from these very ``indptr`` and ``cols`` for this
    width, on X's device.  The structure must be valid CSR with columns in
    [0, n_cols) (:class:`WindowSpmm` checks)."""
    _check(indptr, cols, vals, X)
    r = X.shape[1]
    if lp is not None and not (lp.made_for(indptr, cols, r) and
                               lp.slots.device == X.device):
        raise ValueError(f"the launch plan (r={lp.r}, {lp.slots.numel()} "
                         f"nonzeros on {lp.slots.device}) is not this "
                         "product's: it was made for other tensors, another "
                         "width or another device")
    if X.device.type == "cpu":
        timing.count("window_spmm.twin_calls")
        return window_spmm_ref(indptr, cols, vals, X)
    if X.device.type != "cuda":
        raise ValueError(f"window_spmm has no kernel for {X.device}")
    if r % COL_MULTIPLE or X.data_ptr() % 16:
        raise ValueError(f"the kernel takes r a multiple of {COL_MULTIPLE} "
                         f"and a 16-byte aligned panel, got r={r}")
    if lp is None:
        raise ValueError("the kernel needs the launch plan of this structure "
                         "(plan(), WindowSpmm.launch_plan)")
    lib = build()["lib"]
    with torch.cuda.device(X.device):
        Y = launch(lib, vals, X, lp)
    timing.count("window_spmm.launches")
    return Y


class WindowSpmm(nn.Module):
    """Device-resident CSR operator: Y = A X in complex64 on a panel of
    ``nrhs`` columns, through :func:`window_spmm` (the counterpart of the
    JAX package's ``WindowSpmm`` and ``ChunkSpmm``).  On a CUDA device the
    constructor makes the kernel's launch plan for ``nrhs`` on this card,
    so that later applies make nothing new; other widths get theirs on
    first use."""

    def __init__(self, indptr, cols, vals, shape, nrhs: int = 128,
                 device="cuda"):
        super().__init__()
        indptr = np.asarray(indptr, np.int64)
        cols = np.asarray(cols, np.int64)
        n, n_cols = shape
        if len(indptr) != n + 1 or indptr[0] != 0 or \
                np.any(np.diff(indptr) < 0) or indptr[-1] != len(cols):
            raise ValueError("indptr is not a CSR row pointer of this shape")
        if len(cols) >= 2 ** 31:
            raise ValueError("the kernel indexes nonzeros in int32")
        if len(cols) and not (0 <= cols.min() and cols.max() < n_cols):
            raise ValueError("column index out of range")
        self.n, self.n_cols, self.nrhs = n, n_cols, nrhs
        self.nnz = len(cols)
        #: work of one apply (flops) and the bytes this layout moves: the
        #: values, columns and row pointer, X read once and Y written once
        self.flops = 8.0 * self.nnz * nrhs
        self.stream_bytes = (12.0 * self.nnz + 4.0 * (n + 1)
                             + 8.0 * (n_cols + n) * nrhs)
        self.register_buffer("indptr", torch.from_numpy(
            indptr.astype(np.int32)), persistent=False)
        self.register_buffer("cols", torch.from_numpy(
            cols.astype(np.int32)), persistent=False)
        self.register_buffer("vals", torch.from_numpy(
            np.asarray(vals).astype(np.complex64)), persistent=False)
        self.to(device)
        self._plans = {}
        if self.vals.device.type == "cuda":
            self.launch_plan(nrhs)

    @classmethod
    def from_csr(cls, A: CSR, nrhs: int = 128, device="cuda") -> "WindowSpmm":
        """From a (Cuthill–McKee-reordered) host CSR: plain numpy arrays, so
        the JAX package's assembled operator fits as well."""
        return cls(A.indptr, A.indices, A.data, A.shape, nrhs, device)

    def launch_plan(self, r: int, n_sm: int | None = None) -> WindowLaunch:
        """The kernel's launch plan (:func:`plan`) of this operator's
        structure for width r on a card of ``n_sm`` SMs (default: this
        operator's card), on its device; made once per (r, n_sm)."""
        key = (r, n_sm or sm_count(self.vals.device))
        if key not in self._plans:
            self._plans[key] = plan(self.indptr, self.cols, *key).to(
                self.vals.device)
        return self._plans[key]

    def panel(self, X) -> torch.Tensor:
        """Host [n_cols, nrhs] -> device complex64 panel."""
        X = torch.as_tensor(np.asarray(X, np.complex64))
        return X.to(self.vals.device).contiguous()

    def apply(self, Xd: torch.Tensor, vals: torch.Tensor | None = None
              ) -> torch.Tensor:
        """Y = A X on device tensors (the counterpart of ``apply_split``);
        ``vals`` replaces the operator's values (same structure)."""
        vals = self.vals if vals is None else vals
        lp = self.launch_plan(Xd.shape[1]) if Xd.device.type == "cuda" \
            else None
        return window_spmm(self.indptr, self.cols, vals, Xd, lp)

    def forward(self, X) -> np.ndarray:
        """X [n_cols, nrhs] complex (host) -> Y [n, nrhs] complex64 (host)."""
        return self.apply(self.panel(X)).cpu().numpy()

    def chain(self, m: int, spmm=None):
        """f(Xd) -> m applies, each followed by scaling the whole panel by
        1/max(‖Y‖_F, 1e-30) (the counterpart of ``chain_fn``,
        ``window_spmm.py:275-304``).  ``spmm`` is the product to chain,
        :meth:`apply` by default: :func:`window_spmm_ref` gives the plain
        chain."""
        def product(Xd):
            if spmm is None:
                return self.apply(Xd)
            return spmm(self.indptr, self.cols, self.vals, Xd)

        def call(Xd: torch.Tensor) -> torch.Tensor:
            for _ in range(m):
                Y = product(Xd)
                # on the device, no sync: s = 1 / max(‖Y‖_F, 1e-30)
                Xd = Y * (1.0 / torch.linalg.vector_norm(Y).clamp_min(1e-30))
            return Xd
        return call


__all__ = ["window_spmm", "window_spmm_ref", "build", "bind", "launch",
           "plan", "WindowLaunch", "WindowSpmm", "COL_MULTIPLE", "CHUNK",
           "TILE_ROWS", "STAGE_ROWS", "RING_STAGES", "RING_ROWS",
           "CONSUMER_WARPS", "ROWS_A_WARP"]
