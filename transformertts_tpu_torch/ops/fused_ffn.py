"""``Drop(relu(x W1^T + b1)) W2^T + b2`` in one pass, forward and backward, as
hand-written CUDA kernels for Hopper.

Replaces the TPU kernels of ``transformertts_tpu/ops/pallas/fused_ffn.py``:
``_fwd`` (``_fwd_kernel``, ``_hidden``) and ``_bwd`` (``_bwd_kernel``), entry
``fused_ffn``.  The CUDA source is ``csrc/fused_ffn.cu``.

    hp = x W1^T + b1                        operands in x's dtype, fp32 sums
    hd = keep ? relu(hp) / (1 - p) : 0      fp32, then rounded to x's dtype
    y  = hd W2^T + b2                       fp32 sum and bias, rounded to x's dtype

The (rows, d_ffn) intermediate never reaches device memory.  The backward
recomputes ``hp``, ``hd`` and the dropout mask from (x, W1, b1, seed);
nothing but the inputs is saved.  ``dx`` comes in x's dtype; ``dW1``,
``db1``, ``dW2``, ``db2`` are fp32 sums over all rows (``db1`` sums the fp32
``dh``, the products take ``dh`` and ``hd`` rounded to x's dtype).

Layout: the weights are the PyTorch parameters as they lie, ``w1`` (F, D) =
``Dense_0.weight`` and ``w2`` (D, F) = ``Dense_1.weight``, fp32, and the
gradients come back in that layout.  (The flax kernels are the transposes:
(D, F) and (F, D).)

What bounds it on an H100: operations (4 N D F forward, 10 N D F backward).
fp32 runs them as fp32 FMAs on the CUDA cores, rounding and transposing
weight tiles on their way into shared memory (TF32 would lose the fp32
parity).  bf16 runs them on the tensor cores (wgmma).  The forward in two
launches: the weights rounded to bf16 once per call into scratch, in the
order and swizzled layout of the kernel's shared memory; then one kernel in
which a producer warp bulk-copies each d_ffn slice's weights into a ring
and two warpgroups, each on its own 64 rows of resident x, form hd at each
accumulator element and feed it from registers into y's product; the
blocks of a cluster split d_ffn and add their partial y in rank order
(``fwd_plan`` sizes the grid and the ring).  The backward in four: the
weight cast; a kernel per row tile that forms dh and hd (written to scratch
in bf16) and dx; a kernel per (d_ffn slice, chunk of rows) for dW1 and dW2;
one reduce.  See the source for the tiling.  The parameter gradients go
through per-chunk partial sums added in chunk order, so two runs give the
same bits (no atomics).  ``bwd_plan`` sizes the grids, ``bwd_scratch`` the
scratch.

What the TPU shaped and this port keeps only as a number: the mask is keyed
on (row block, local row, column) of the TPU kernel's row blocks
(``pick_rows``, which follows that kernel's memory budget and so depends on
the itemsize).  The CUDA kernels take the block height as an argument that
shapes nothing but the mask, so forward, backward, the plain version and the
JAX package all drop the same elements for one seed.  Under data and tensor
parallelism (``parallel/``) a call holds some batch rows and some d_ffn
columns; ``row_map`` (as in ``fused_ln.py``) and ``col_map = (f_total,
c0)`` key its mask on the one-device call's row and column, counter
``(g % mask_rows) * f_total + c0 + col``, so every rank drops what that
call drops.

On a CUDA tensor ``fused_ffn`` launches the kernels or raises; the plain
version runs for CPU tensors, or on any device when the caller passes
``plain=True``.
"""

from __future__ import annotations

import ctypes

import torch

from transformertts_tpu_torch.ops.dropout_mask import keep_from_index, threshold_of
from transformertts_tpu_torch.ops.fused_ln import global_rows

_MASK_BUDGET = 13 * 1024 * 1024  # the TPU kernel's memory budget: shapes the mask only


def _bwd_vmem(rows: int, d: int, f: int, itemsize: int) -> int:
    """Memory estimate of the TPU backward kernel (``fused_ffn.py:_bwd_vmem``)."""
    fixed = 8 * d * f + 2 * itemsize * d * f
    per_row = 3 * d * itemsize + 4 * d + 12 * f
    return fixed + rows * per_row


def pick_rows(n: int, d: int, f: int, itemsize: int) -> int:
    """Row-block height of the TPU kernel (``fused_ffn.py:_pick_rows``): the
    geometry the dropout mask is keyed on.  The largest candidate within the
    budget that divides n, else the largest within the budget (the TPU kernel
    then pads n; the mask of the first n rows is the same)."""
    fitting = [c for c in (256, 128, 64, 32, 16, 8)
               if _bwd_vmem(c, d, f, itemsize) <= _MASK_BUDGET]
    if not fitting:
        raise ValueError(f"fused_ffn: no mask geometry for d_model={d}, d_ffn={f} "
                         f"(the TPU kernel does not take these widths either)")
    for cand in fitting:
        if n % cand == 0:
            return cand
    return fitting[0]


def _hidden(x, w1, b1, seed, dropout, mask_rows, row_map=None, col_map=None):
    """(hp, hd, keep) in fp32 on (N, D) rows; ``keep`` is None without dropout."""
    n, f = x.shape[0], w1.shape[0]
    hp = x.float() @ w1.to(x.dtype).float().t() + b1.float()
    h = torch.clamp(hp, min=0.0)
    if dropout <= 0.0:
        return hp, h, None
    f_total, c0 = col_map or (f, 0)
    rows = global_rows(n, row_map, x.device)
    cols = torch.arange(c0, c0 + f, dtype=torch.int64, device=x.device)[None, :]
    keep = keep_from_index((rows % mask_rows) * f_total + cols, rows // mask_rows, seed, dropout)
    return hp, torch.where(keep, h / (1.0 - dropout), torch.zeros_like(h)), keep


def fused_ffn_reference(x, w1, b1, w2, b2, seed, dropout, mask_rows, row_map=None,
                        col_map=None):
    """Plain version of the forward kernel on (N, D) rows: the products in
    fp32 on operands rounded to x's dtype (exact for bf16 products)."""
    _, hd, _ = _hidden(x, w1, b1, seed, dropout, mask_rows, row_map, col_map)
    y = hd.to(x.dtype).float() @ w2.to(x.dtype).float().t() + b2.float()
    return y.to(x.dtype)


def fused_ffn_backward_reference(x, w1, b1, w2, dy, seed, dropout, mask_rows, row_map=None,
                                 col_map=None):
    """Plain version of the backward kernels: (dx, dW1, db1, dW2, db2), the
    last four fp32 in the parameters' layout."""
    hp, hd, keep = _hidden(x, w1, b1, seed, dropout, mask_rows, row_map, col_map)
    dy32 = dy.float()
    dhd = dy32 @ w2.to(x.dtype).float()
    dh = torch.where(hp > 0.0, dhd, torch.zeros_like(dhd))
    if keep is not None:
        dh = torch.where(keep, dh / (1.0 - dropout), torch.zeros_like(dh))
    dh_c = dh.to(x.dtype).float()
    dx = dh_c @ w1.to(x.dtype).float()
    dw1 = dh_c.t() @ x.float()
    dw2 = dy32.t() @ hd.to(x.dtype).float()
    return dx.to(x.dtype), dw1, dh.sum(dim=0), dw2, dy32.sum(dim=0)


_SMS = 132  # streaming multiprocessors of an H100 SXM
_TILE = 64  # rows of a row tile, d_ffn columns of a slice (bf16 backward)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_plan(n: int, d: int, f: int) -> dict:
    """Grids of the bf16 backward for (N, D, F): the dh kernel takes one
    block (one a SM) per row tile and group of ``spg`` d_ffn slices of 32,
    with the number of groups, ``fgroups``, that fills the last wave best;
    the gradient kernel's weight-gradient products take one block per (pair
    of 64-wide slices, chunk of ``tpc`` row tiles, product, group of 256
    d_model columns), about one on every other SM (the dx products take the
    rest)."""
    tiles, slices, dgroups = _cdiv(n, _TILE), _cdiv(f, _TILE), _cdiv(d, 4 * _TILE)
    dh_slices = 2 * slices  # 32 wide

    def fill(groups):  # the share of the SMs' waves that the blocks fill
        blocks = tiles * groups
        return blocks / (_cdiv(blocks, _SMS) * _SMS)

    spg = _cdiv(dh_slices, max(range(1, min(8, dh_slices) + 1), key=lambda g: (fill(g), -g)))
    chunks = max(1, min(tiles, _SMS // 2 // (2 * _cdiv(slices, 2) * dgroups)))
    tpc = _cdiv(tiles, chunks)
    return {"tiles": tiles, "spg": spg, "fgroups": _cdiv(dh_slices, spg), "tpc": tpc,
            "chunks": _cdiv(tiles, tpc), "dp": _cdiv(d, _TILE) * _TILE,
            "fp": slices * _TILE}


_SMEM_MAX = 232448  # dynamic shared memory a block may take on an H100
# blocks of the bf16 forward the card holds at once, by cluster size: one a SM,
# whole clusters within a GPC (measured: clusters of 8 take two waves for 128)
_FWD_HELD = {1: _SMS, 2: _SMS, 4: 128, 8: 120}
_GROUP = 4 * _TILE  # output columns of a block of the bf16 forward
_LD_RED = _GROUP + 8  # row length of the forward's fp32 partial y in shared memory


def fwd_plan(n: int, d: int, f: int) -> dict:
    """Grid and shared memory of the bf16 forward for (N, D, F).

    A block takes ``wgs`` row tiles of 64 (one warpgroup each: two for
    d_model up to 256, one above, where a tile's resident x takes up to
    128 KB), one group of 256 output columns, and one of ``fsplit`` parts of
    the d_ffn slices of ``s`` columns; the ``fsplit`` blocks of a row block
    form a cluster that adds their partial y in rank order.  ``fsplit``
    (1, 2, 4 or 8) minimises a cost calibrated on an H100 (waves of blocks
    the card holds at once, times a block's start, its slices at ~2.5 us a
    64-wide slice of 128 rows, and ~6 us of cluster reduction), the smaller
    on a tie; ``stages`` is the deepest weight ring
    (at most 4) that fits the shared memory: 2 at d_model up to 256, 3 up to
    512, 1 above.  Raises above d_model 1,024."""
    if d > 4 * _GROUP:
        raise ValueError(f"the bf16 fused FFN forward takes d_model up to {4 * _GROUP}, got {d}")
    # the kernel is built for d_model 256, 512 and 1,024; x and W1 past d are zeros
    dp = next(w for w in (_GROUP, 2 * _GROUP, 4 * _GROUP) if d <= w)
    fp, n_dg = _cdiv(f, _TILE) * _TILE, _cdiv(d, _GROUP)
    s, wgs = (64, 2) if dp <= _GROUP else (32, 1)
    slices, row_blocks = fp // s, _cdiv(n, wgs * _TILE)

    def cost(fs):  # us, from the card: a block's slices, start and cluster reduction
        per_slice = 2.5 * s * wgs / 128
        start = 3.5 if fs == 1 else 9.0
        waves = _cdiv(row_blocks * n_dg * fs, _FWD_HELD[fs])
        return waves * (start + per_slice * _cdiv(slices, fs))

    fsplit = min((fs for fs in (1, 2, 4, 8) if fs <= slices), key=lambda fs: (cost(fs), fs))
    x_bytes, stage = wgs * _TILE * dp * 2, s * dp * 2 + _GROUP * s * 2
    red = wgs * _TILE * _LD_RED * 4

    def smem(k):
        return max(x_bytes + k * stage, red) + 12 * k + 1024  # + an mbarrier, a counter a stage

    stages = max(k for k in (1, 2, 3, 4) if k == 1 or smem(k) <= _SMEM_MAX)
    return {"s": s, "wgs": wgs, "slices": slices, "groups": n_dg,
            "fsplit": fsplit, "stages": stages, "smem": smem(stages), "dp": dp, "fp": fp,
            "staged_bytes": slices * (s * dp * 2 + n_dg * _GROUP * s * 2),
            "grid": (fsplit, row_blocks, n_dg), "threads": wgs * 128}


def fwd_parts(slices: int, fsplit: int) -> list[range]:
    """The d_ffn slices each block of a cluster takes, by rank (as the
    kernel splits them)."""
    return [range(q * slices // fsplit, (q + 1) * slices // fsplit) for q in range(fsplit)]


def fwd_reduce_rows(wgs: int, fsplit: int) -> list[range]:
    """The rows of a block's partial y that block ``rank`` of the cluster
    adds up (over every rank, in rank order) and stores, by rank."""
    return [range(q, wgs * _TILE, fsplit) for q in range(fsplit)]


def bwd_scratch(n: int, d: int, f: int) -> dict:
    """Byte offset and size of each scratch array of the bf16 backward in
    one buffer (256-byte aligned), and the buffer's size under "total"."""
    pl = bwd_plan(n, d, f)
    sizes = {"w1b": 2 * pl["fp"] * pl["dp"], "w2b": 2 * pl["dp"] * pl["fp"],
             "dh": 2 * n * pl["fp"], "hd": 2 * n * pl["fp"],
             "pdb1": 4 * pl["tiles"] * f, "pdb2": 4 * pl["tiles"] * d,
             "pw1": 4 * pl["chunks"] * f * d, "pw2": 4 * pl["chunks"] * d * f}
    out, at = {}, 0
    for name, size in sizes.items():
        out[name] = (at, size)
        at += _cdiv(size, 256) * 256
    out["total"] = (0, at)
    return out


def _lib():
    from transformertts_tpu_torch import _build

    lib = _build.load("fused_ffn")
    if not getattr(lib, "_argtypes_set", False):
        i, u, f, p = ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p
        tail = [i, f, u, u, i] + [i] * 5 + [p]
        lib.tts_fused_ffn_fwd.argtypes = [i] * 3 + [p] * 6 + tail
        lib.tts_fused_ffn_fwd_tc.argtypes = [i] * 3 + [p] * 7 + [i, i] + tail
        lib.tts_fused_ffn_fwd_tc_bytes.argtypes = [i, i, i, p]
        lib.tts_fused_ffn_bwd.argtypes = [i] * 3 + [p] * 8 + tail
        lib.tts_fused_ffn_bwd_tc.argtypes = [i] * 3 + [p] * 15 + [i] * 4 + tail
        lib.tts_fused_ffn_bwd_chunks.argtypes = [i, i]
        lib.tts_fused_ffn_shared_bytes.argtypes = [i, p]
        for fn in (lib.tts_fused_ffn_fwd, lib.tts_fused_ffn_fwd_tc, lib.tts_fused_ffn_fwd_tc_bytes,
                   lib.tts_fused_ffn_bwd, lib.tts_fused_ffn_bwd_tc,
                   lib.tts_fused_ffn_bwd_chunks, lib.tts_fused_ffn_shared_bytes):
            fn.restype = i
        lib._argtypes_set = True
    return lib


def _check_cuda_args(x, w1, b1, w2, b2=None, dy=None):
    """Raise unless the kernels can read these: dtype, shape, device,
    contiguity and the 16-byte vectors their loads use."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused FFN kernel takes float32 or bfloat16, got {x.dtype}")
    n, d = x.shape
    f = w1.shape[0]
    if d % 8 or f % 4:
        raise ValueError(f"fused FFN kernel takes d_model a multiple of 8 and d_ffn a multiple "
                         f"of 4, got {d} and {f}")
    wanted = [("x", x, x.dtype, (n, d)), ("w1", w1, torch.float32, (f, d)),
              ("b1", b1, torch.float32, (f,)), ("w2", w2, torch.float32, (d, f))]
    if b2 is not None:
        wanted.append(("b2", b2, torch.float32, (d,)))
    if dy is not None:
        wanted.append(("dy", dy, x.dtype, (n, d)))
    for name, t, dtype, shape in wanted:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"fused FFN: {name} must be a contiguous 16-byte aligned {dtype} of shape "
                f"{shape} on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _mask_args(x, f, seed, dropout, mask_rows, row_map, col_map):
    n = x.shape[0]
    return (int(dropout > 0.0), 1.0 - dropout, threshold_of(dropout), seed, mask_rows,
            *(row_map or (n, n, 0)), *(col_map or (f, 0)),
            torch.cuda.current_stream(x.device).cuda_stream)


def fused_ffn_forward(x, w1, b1, w2, b2, seed, dropout, mask_rows, row_map=None, col_map=None):
    """The forward kernel on contiguous (N, D) CUDA rows: y, or raises.
    bf16 launches the tensor-core kernel (after the weights' staging
    kernel), fp32 the CUDA-core one."""
    _check_cuda_args(x, w1, b1, w2, b2)
    n, d = x.shape
    f = w1.shape[0]
    y = torch.empty_like(x)
    ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            y.data_ptr())
    mask = _mask_args(x, f, seed, dropout, mask_rows, row_map, col_map)
    if x.dtype == torch.bfloat16:
        plan = fwd_plan(n, d, f)
        staged = torch.empty(plan["staged_bytes"], dtype=torch.uint8, device=x.device)
        rc = _lib().tts_fused_ffn_fwd_tc(n, d, f, *ptrs, staged.data_ptr(), plan["fsplit"],
                                         plan["stages"], *mask)
    else:
        rc = _lib().tts_fused_ffn_fwd(n, d, f, *ptrs, *mask)
    if rc != 0:
        raise RuntimeError(f"fused FFN forward kernel failed to launch (CUDA error {rc}) "
                           f"for N={n}, D={d}, F={f}, {x.dtype}")
    fused_ffn.launches_fwd += 1
    return y


def fused_ffn_backward(x, w1, b1, w2, dy, seed, dropout, mask_rows, row_map=None, col_map=None):
    """The backward kernels (bf16: weight cast, dh / hd, gradients, reduce;
    fp32: dx, parameter partials, two reduces; behind one
    entry point) on contiguous (N, D) CUDA rows: (dx, dW1, db1, dW2, db2),
    the last four fp32 views of one buffer, or raises."""
    n, d = x.shape
    f = w1.shape[0]
    _check_cuda_args(x, w1, b1, w2, dy=dy)
    lib = _lib()
    mask = _mask_args(x, f, seed, dropout, mask_rows, row_map, col_map)
    dx = torch.empty_like(x)
    grads = torch.empty(2 * f * d + f + d, dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), grads.data_ptr())
    if x.dtype == torch.bfloat16:
        plan, layout = bwd_plan(n, d, f), bwd_scratch(n, d, f)
        scratch = torch.empty(layout["total"][1], dtype=torch.uint8, device=x.device)
        rc = lib.tts_fused_ffn_bwd_tc(
            n, d, f, *ptrs, *(scratch.data_ptr() + layout[k][0]
                              for k in ("w1b", "w2b", "dh", "hd", "pdb1", "pdb2", "pw1", "pw2")),
            plan["spg"], plan["fgroups"], plan["tpc"], plan["chunks"], *mask)
    else:
        part = torch.empty(lib.tts_fused_ffn_bwd_chunks(n, f) * grads.numel(),
                           dtype=torch.float32, device=x.device)
        rc = lib.tts_fused_ffn_bwd(n, d, f, *ptrs, part.data_ptr(), *mask)
    if rc != 0:
        raise RuntimeError(f"fused FFN backward kernels failed to launch (CUDA error {rc}) "
                           f"for N={n}, D={d}, F={f}, {x.dtype}")
    fused_ffn.launches_bwd += 1
    dw1, db1, db2, dw2 = grads.split((f * d, f, d, d * f))
    return dx, dw1.view(f, d), db1, dw2.view(d, f), db2


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, dropout, mask_rows, row_map, col_map, plain):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.args = (seed, dropout, mask_rows, row_map, col_map, plain)
        fwd = fused_ffn_reference if plain or x.device.type == "cpu" else fused_ffn_forward
        return fwd(x, w1, b1, w2, b2, seed, dropout, mask_rows, row_map, col_map)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        seed, dropout, mask_rows, row_map, col_map, plain = ctx.args
        bwd = (fused_ffn_backward_reference if plain or x.device.type == "cpu"
               else fused_ffn_backward)
        dx, dw1, db1, dw2, db2 = bwd(x, w1, b1, w2, dy.contiguous(), seed, dropout, mask_rows,
                                     row_map, col_map)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b1.dtype),
                None, None, None, None, None, None)


def fused_ffn(
    x: torch.Tensor,  # (..., D)
    w1: torch.Tensor,  # (F, D) fp32, the layout of nn.Linear(D, F).weight
    b1: torch.Tensor,  # (F,)
    w2: torch.Tensor,  # (D, F) fp32, the layout of nn.Linear(F, D).weight
    b2: torch.Tensor,  # (D,)
    dropout: float = 0.0,
    seed: int = 0,
    mask_rows: int | None = None,
    plain: bool = False,
    row_map: tuple[int, int, int] | None = None,
    col_map: tuple[int, int] | None = None,
) -> torch.Tensor:
    """The feed-forward block in one pass; differentiable in x and the four
    parameters.

    ``seed`` is the int32 seed of this call's mask (``seed_from_generator``);
    ``mask_rows`` the mask's block height, by default the TPU kernel's
    (``pick_rows``); ``row_map = (t_local, t_total, offset)`` and ``col_map =
    (f_total, c0)`` place the call's rows and d_ffn columns in the one-device
    call's (default: the call is the whole; a caller that passes them passes
    that call's ``mask_rows`` too).  ``plain=True`` asks for the plain
    version whatever the device."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if mask_rows is None:
        mask_rows = pick_rows(x2.shape[0], d, w1.shape[0], x.element_size())
    row_map = tuple(int(i) for i in row_map) if row_map is not None else None
    col_map = tuple(int(i) for i in col_map) if col_map is not None else None
    y = _FusedFFN.apply(x2.contiguous(), w1.float().contiguous(), b1.float().contiguous(),
                        w2.float().contiguous(), b2.float().contiguous(), int(seed),
                        float(dropout), int(mask_rows), row_map, col_map, bool(plain))
    return y.reshape(x.shape)


fused_ffn.launches_fwd = 0  # forward kernel launches
fused_ffn.launches_bwd = 0  # backward calls (its four kernels together)
