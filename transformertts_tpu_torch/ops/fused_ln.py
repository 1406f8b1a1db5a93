"""``LayerNorm(x + Dropout(h))`` in one pass, forward and backward, as a
hand-written CUDA kernel pair for Hopper.

Replaces the TPU kernels of ``transformertts_tpu/ops/pallas/fused_ln.py``:
``_fwd`` (``_fwd_kernel``) and ``_bwd`` (``_bwd_kernel``), entry
``residual_dropout_layernorm``.  The CUDA source is ``csrc/fused_ln.cu``.

    z = x + (keep ? h / (1 - p) : 0)           fp32 from the loads on
    y = (z - mean z) * rsqrt(max(E[z^2] - mean^2, 0) + eps) * gamma + beta

with y, dx, dh in the storage dtype of x and dgamma, dbeta summed in fp32.
The backward recomputes z, the statistics and the dropout mask from
(x, h, seed); nothing but the inputs is saved.

What bounds it on an H100: bytes (three (N, D) arrays forward, five
backward, about ten operations per element).  One warp per row, 16-byte
loads, the row kept in registers, so each element is read once.  The
backward is one launch: about two blocks per SM, each on a run of rows;
dgamma and dbeta go through per-block partial sums that the last blocks to
finish add in a fixed order (ticket counters, no atomic float adds), so two
runs give the same bits.

What the TPU shaped and this port keeps only as a number: the mask is keyed
on (row block, local row, column) of the TPU kernel's row blocks
(``pick_rows``).  The CUDA kernel works in rows, not blocks, and takes the
block height as an argument that shapes nothing but the mask, so forward,
backward, the plain version and the JAX package all drop the same elements
for one seed.  Under data and sequence parallelism (``parallel/``) a call
holds some batch rows and a time slice of each; ``row_map = (t_local,
t_total, offset)`` keys its mask on the global row
``(row // t_local) * t_total + row % t_local + offset`` of the one-device
call (``offset = b0 * t_total + t0``), so every rank drops what that call
drops.

On a CUDA tensor ``residual_dropout_layernorm`` launches the kernels or
raises; the plain version runs for CPU tensors, or on any device when the
caller passes ``plain=True``.
"""

from __future__ import annotations

import ctypes

import torch

from transformertts_tpu_torch.ops.dropout_mask import keep_from_index, threshold_of


def pick_rows(n: int, d: int) -> int:
    """Row-block height of the TPU kernel (``fused_ln.py:_pick_rows``): the
    geometry the dropout mask is keyed on."""
    budget_rows = (14 * 1024 * 1024) // (40 * d)
    for cand in (512, 256, 128, 64, 32, 16, 8):
        if cand <= budget_rows and n % cand == 0:
            return cand
    return n


def global_rows(n: int, row_map, device) -> torch.Tensor:
    """(n, 1) int64 global row of each of a call's n rows under ``row_map``
    (None: the call is the whole)."""
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    if row_map is None:
        return rows
    t_local, t_total, offset = row_map
    return (rows // t_local) * t_total + rows % t_local + offset


def _z_and_stats(x, h, seed, dropout, eps, mask_rows, row_map=None):
    n, d = x.shape
    x = x.float()
    h = h.float()
    keep = None
    if dropout > 0.0:
        rows = global_rows(n, row_map, x.device)
        cols = torch.arange(d, dtype=torch.int64, device=x.device)[None, :]
        keep = keep_from_index((rows % mask_rows) * d + cols, rows // mask_rows, seed, dropout)
        h = torch.where(keep, h / (1.0 - dropout), torch.zeros_like(h))
    z = x + h
    mu = z.mean(dim=1, keepdim=True)
    var = (z * z).mean(dim=1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return z, mu, rstd, keep


def residual_dropout_layernorm_reference(x, h, gamma, beta, seed, dropout, eps, mask_rows,
                                         row_map=None):
    """Plain version of the forward kernel on (N, D) arrays."""
    z, mu, rstd, _ = _z_and_stats(x, h, seed, dropout, eps, mask_rows, row_map)
    y = (z - mu) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype)


def residual_dropout_layernorm_backward_reference(x, h, gamma, dy, seed, dropout, eps, mask_rows,
                                                  row_map=None):
    """Plain version of the backward kernel: (dx, dh, dgamma, dbeta), the
    last two fp32 of shape (D,)."""
    z, mu, rstd, keep = _z_and_stats(x, h, seed, dropout, eps, mask_rows, row_map)
    zhat = (z - mu) * rstd
    dy = dy.float()
    dg = (dy * zhat).sum(dim=0)
    db = dy.sum(dim=0)
    gf = dy * gamma.float()
    m1 = gf.mean(dim=1, keepdim=True)
    m2 = (gf * zhat).mean(dim=1, keepdim=True)
    dz = rstd * (gf - m1 - zhat * m2)
    dh = torch.where(keep, dz / (1.0 - dropout), torch.zeros_like(dz)) if dropout > 0.0 else dz
    return dz.to(x.dtype), dh.to(h.dtype), dg, db


# backward grid: about 8 rows a block (one a warp), at most two blocks on each of 132 SMs
_BWD_ROWS_PER_BLOCK, _BWD_MAX_BLOCKS, _BWD_GROUP = 8, 264, 16
_counters: dict = {}  # (device, stream) -> the backward's ticket counters


def bwd_blocks(n: int) -> int:
    """Blocks of the backward kernel for n rows."""
    return max(1, min(-(-n // _BWD_ROWS_PER_BLOCK), _BWD_MAX_BLOCKS))


def bwd_scratch_floats(n: int, d: int) -> int:
    """fp32 scratch of the backward: a (2, D) partial per block and per
    group of ``_BWD_GROUP`` blocks."""
    blocks = bwd_blocks(n)
    return (blocks + -(-blocks // _BWD_GROUP)) * 2 * d


def ticket_counters(device: torch.device, stream: int) -> torch.Tensor:
    """The backward's ticket counters on ``device`` for ``stream``: zeros,
    allocated at the first call only (every launch leaves them at zero, so
    no call clears them); one set per stream, since two launches in flight
    at once must not share one."""
    key = (str(device), stream)
    if key not in _counters:
        # 1 + ceil(blocks / 16) for the kernel's largest grid, 528 blocks
        _counters[key] = torch.zeros(1 + -(-528 // _BWD_GROUP), dtype=torch.int32, device=device)
    return _counters[key]


def _lib():
    from transformertts_tpu_torch import _build

    lib = _build.load("fused_ln")
    if not getattr(lib, "_argtypes_set", False):
        i, u, f, p = ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p
        lib.tts_fused_ln_fwd.argtypes = [i, i, i, p, p, p, p, p, f, i, f, u, u, i, i, i, i, p]
        lib.tts_fused_ln_bwd.argtypes = [i, i, i, p, p, p, p, p, p, p, p, p, i, f, i, f, u, u,
                                         i, i, i, i, p]
        lib.tts_keep_mask.argtypes = [i, i, u, u, u, p, p]
        lib.tts_fused_ln_bwd_shared_bytes.argtypes = [i]
        lib.tts_fused_ln_bwd_shared_bytes.restype = ctypes.c_longlong
        for fn in (lib.tts_fused_ln_fwd, lib.tts_fused_ln_bwd, lib.tts_keep_mask):
            fn.restype = i
        lib._argtypes_set = True
    return lib


def _check_cuda_args(x, h, gamma, beta, extra=()):
    """Raise unless the kernel can read these: dtype, shape, device,
    contiguity and the 16-byte vectors its loads use."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused LN kernel takes float32 or bfloat16, got {x.dtype}")
    n, d = x.shape
    vec = 16 // x.element_size()
    if d % vec or d > 1024:
        raise ValueError(f"fused LN kernel takes D a multiple of {vec} up to 1024, got {d}")
    for name, t, dtype, shape in (
        ("h", h, x.dtype, (n, d)), ("gamma", gamma, torch.float32, (d,)),
        ("beta", beta, torch.float32, (d,)),
        *((name, t, x.dtype, (n, d)) for name, t in extra),
    ):
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"fused LN: {name} must be a contiguous 16-byte aligned {dtype} of shape "
                f"{shape} on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused LN: x must be contiguous and 16-byte aligned")


def _row_map_args(n: int, row_map) -> tuple:
    return tuple(row_map) if row_map is not None else (n, n, 0)


def fused_ln_forward(x, h, gamma, beta, seed, dropout, eps, mask_rows, row_map=None):
    """The forward kernel on contiguous (N, D) CUDA tensors: y, or raises."""
    g32, b32 = gamma.float().contiguous(), beta.float().contiguous()
    _check_cuda_args(x, h, g32, b32)
    y = torch.empty_like(x)
    n, d = x.shape
    rc = _lib().tts_fused_ln_fwd(
        int(x.dtype == torch.bfloat16), n, d, x.data_ptr(), h.data_ptr(), g32.data_ptr(),
        b32.data_ptr(), y.data_ptr(), eps, int(dropout > 0.0), 1.0 - dropout,
        threshold_of(dropout), seed, mask_rows, *_row_map_args(n, row_map),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused LN forward kernel failed to launch (CUDA error {rc}) "
                           f"for N={n}, D={d}, {x.dtype}")
    residual_dropout_layernorm.launches_fwd += 1
    return y


def fused_ln_backward(x, h, gamma, dy, seed, dropout, eps, mask_rows, row_map=None):
    """The backward kernel, one launch, on contiguous (N, D) CUDA tensors:
    (dx, dh, dgamma, dbeta), the last two fp32, or raises."""
    g32 = gamma.float().contiguous()
    _check_cuda_args(x, h, g32, g32, extra=(("dy", dy),))
    n, d = x.shape
    dx, dh = torch.empty_like(x), torch.empty_like(h)
    dgb = torch.empty((2, d), dtype=torch.float32, device=x.device)
    part = torch.empty(bwd_scratch_floats(n, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().tts_fused_ln_bwd(
        int(x.dtype == torch.bfloat16), n, d, x.data_ptr(), h.data_ptr(),
        g32.data_ptr(), dy.data_ptr(), dx.data_ptr(), dh.data_ptr(), dgb.data_ptr(),
        part.data_ptr(), ticket_counters(x.device, stream).data_ptr(), bwd_blocks(n), eps,
        int(dropout > 0.0), 1.0 - dropout, threshold_of(dropout), seed, mask_rows,
        *_row_map_args(n, row_map), stream)
    if rc != 0:
        raise RuntimeError(f"fused LN backward kernel failed to launch (CUDA error "
                           f"{rc}) for N={n}, D={d}, {x.dtype}")
    residual_dropout_layernorm.launches_bwd += 1
    return dx, dh, dgb[0], dgb[1]


class _FusedLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, gamma, beta, seed, dropout, eps, mask_rows, row_map, plain):
        ctx.save_for_backward(x, h, gamma)
        ctx.args = (seed, dropout, eps, mask_rows, row_map, plain)
        fwd = (residual_dropout_layernorm_reference if plain or x.device.type == "cpu"
               else fused_ln_forward)
        return fwd(x, h, gamma, beta, seed, dropout, eps, mask_rows, row_map)

    @staticmethod
    def backward(ctx, dy):
        x, h, gamma = ctx.saved_tensors
        seed, dropout, eps, mask_rows, row_map, plain = ctx.args
        bwd = (residual_dropout_layernorm_backward_reference
               if plain or x.device.type == "cpu" else fused_ln_backward)
        dx, dh, dg, db = bwd(x, h, gamma, dy.contiguous(), seed, dropout, eps, mask_rows,
                             row_map)
        return (dx, dh, dg.to(gamma.dtype), db.to(gamma.dtype), None, None, None, None, None,
                None)


def residual_dropout_layernorm(
    x: torch.Tensor,  # (..., D) residual stream
    h: torch.Tensor,  # (..., D) sublayer output (dropout applies to this)
    gamma: torch.Tensor,  # (D,) LayerNorm scale
    beta: torch.Tensor,  # (D,) LayerNorm bias
    dropout: float = 0.0,
    seed: int = 0,
    eps: float = 1e-5,
    mask_rows: int | None = None,
    plain: bool = False,
    row_map: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """``LayerNorm(x + Dropout(h))``; differentiable in x, h, gamma, beta.

    ``seed`` is the int32 seed of this call's mask (``seed_from_generator``);
    ``mask_rows`` the mask's block height, by default the TPU kernel's
    (``pick_rows``); ``row_map = (t_local, t_total, offset)`` places the
    call's rows among the one-device call's (default: the call is the whole;
    a caller that passes it passes the whole call's ``mask_rows`` too).
    ``plain=True`` asks for the plain version whatever the device."""
    d = x.shape[-1]
    x2, h2 = x.reshape(-1, d), h.reshape(-1, d).to(x.dtype)
    if mask_rows is None:
        mask_rows = pick_rows(x2.shape[0], d)
    if row_map is not None:
        row_map = tuple(int(i) for i in row_map)
    y = _FusedLN.apply(x2.contiguous(), h2.contiguous(), gamma, beta, int(seed),
                       float(dropout), float(eps), int(mask_rows), row_map, bool(plain))
    return y.reshape(x.shape)


residual_dropout_layernorm.launches_fwd = 0  # forward kernel launches
residual_dropout_layernorm.launches_bwd = 0  # backward kernel launches
