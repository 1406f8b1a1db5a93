"""One whole decoder step as ONE hand-written persistent kernel for Hopper.

Replaces both TPU decode-step kernels of the JAX package:

- ``transformertts_tpu/ops/pallas/decode_step.py:decode_step`` (``_kernel``,
  batch 1), and
- ``decode_step_batched`` (``_kernel_batched``, B <= 8).

One code path serves 1 <= B <= 8 (the rows a cluster decodes are a
template parameter of the CUDA source, ``ops/csrc/decode_step.cu``).  The
step is

    prenet -> + alpha*PE[t] -> L x [cached self-attention, the current
    position folded in closed form -> + residual, LN1 -> cross-attention
    with an additive key bias -> + residual, LN2 -> FFN -> + residual,
    LN3] -> fused mel|stop head

with bf16 (or fp32) operands and fp32 accumulation, q scaled in fp32 then
cast, fp32 softmax and LayerNorm (``E[x^2] - mu^2`` clamped at 0), and x
cast to the compute type after each sublayer while the residual stays
fp32 — the numerics of ``_kernel``.

What bounds it on an H100: bytes, in principle.  Every step reads all
decoder weights (about 2.87 M parameters, 5.7 MB in bf16 at d_model 256,
3 layers, d_ffn 1024; 44 MB at ``configs/paper.yaml`` widths) plus, per
batch row, the caches: 1.7-2 us at 3.35 TB/s at ``Config()`` widths.  The
arithmetic (2 FLOPs per weight per row) is far below the tensor-core
roofline, so the products stay on the CUDA cores.  In practice latency
bounds it: the step is a chain of about 10 L dependent stages.

The design (the CUDA source's header has the details): one launch per
step; a cluster of 16 blocks, one per SM, decodes ``rows`` batch rows
(``rows_per_cluster``: as few as the card can hold clusters for at once);
the stages are separated by the cluster barrier and hand their outputs to
every block's shared memory directly; each block streams the weight
pieces of the columns it owns (``decode_plan``) into a shared-memory ring
with bulk asynchronous copies ahead of the chain; attention is split into
(row, head, key chunk) items over the cluster's blocks (``attn_chunks``)
and combined in chunk order, rounding each probability against the
global max as the reference does.  Everything the kernel is handed besides
pointers (plan, chunks, shared-memory layout) is computed here, where the
CPU tests reach it.  ``DecodeStep`` prepares a step once per decode (the
checks, the plan, the buffers), so that each step costs the host one C
call; ``decode_step`` keeps the function's signature and prepares through
a small cache.

What the TPU shaped and this port drops: the batched TPU kernel flattened
the caches to (L, H, B*T, dh) and scored every row against every row's
cache under a block-diagonal bias (``expand_cross_bias``); here each row
attends to its own (L, H, B, T, dh) segment and the kernel takes the
(B, Tp) cross bias directly.  The TPU's per-head weight splits on leading
dims become plain (out, in) row-major matrices, q|k|v fused into one.

The kernel writes the new K/V rows straight into the self-attention
caches at position ``t``, in place, and also returns them.  The wrapper
does the same on the CPU path, so both devices leave the caches alike.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict

import numpy as np
import torch

from transformertts_tpu_torch.models.masks import NEG_INF

# order of the weight pointers handed to the C entry point
_PACK_ORDER = (
    "pw1", "pb1", "pw2", "pb2",
    "sWqkv", "sbqkv", "sWo", "sbo",
    "cWq", "cbq", "cWo", "cbo",
    "W1", "B1", "W2", "B2", "ln_g", "ln_b",
    "head_w", "head_b",
)
MAX_BATCH = 8  # the CUDA source instantiates B = 1..8


@torch.no_grad()
def pack_decode_weights(model, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Decoder weights of a ``TransformerTTS`` in the kernel's layout.

    The content of the JAX ``pack_decode_weights``: matrices as (out, in)
    row-major in ``dtype`` (a warp per output column reads its row in
    16-byte vectors), biases in ``dtype``, the self-attention q|k|v
    projections fused into one (3D, D) matrix, the mel and stop heads fused
    into one (n_mels*r + r, D) matrix, LayerNorm parameters in fp32 as
    (L, 3, D).
    """
    layers = model.decoder.layers

    def w(lin):  # torch Linear layout (out, in)
        return lin.weight.to(dtype).contiguous()

    def b(lin):
        return lin.bias.to(dtype).contiguous()

    def stack(fn):
        return torch.stack([fn(lyr) for lyr in layers]).contiguous()

    pn = model.dec_prenet
    heads = (model.mel_linear.Dense_0, model.stop_linear.Dense_0)
    return {
        "pw1": w(pn.LinearNorm_0.Dense_0), "pb1": b(pn.LinearNorm_0.Dense_0),
        "pw2": w(pn.LinearNorm_1.Dense_0), "pb2": b(pn.LinearNorm_1.Dense_0),
        "sWqkv": stack(lambda l: torch.cat(
            [w(l.self_attn.q_proj), w(l.self_attn.k_proj), w(l.self_attn.v_proj)])),
        "sbqkv": stack(lambda l: torch.cat(
            [b(l.self_attn.q_proj), b(l.self_attn.k_proj), b(l.self_attn.v_proj)])),
        "sWo": stack(lambda l: w(l.self_attn.out_proj)),
        "sbo": stack(lambda l: b(l.self_attn.out_proj)),
        "cWq": stack(lambda l: w(l.cross_attn.q_proj)),
        "cbq": stack(lambda l: b(l.cross_attn.q_proj)),
        "cWo": stack(lambda l: w(l.cross_attn.out_proj)),
        "cbo": stack(lambda l: b(l.cross_attn.out_proj)),
        "W1": stack(lambda l: w(l.ffn.Dense_0)), "B1": stack(lambda l: b(l.ffn.Dense_0)),
        "W2": stack(lambda l: w(l.ffn.Dense_1)), "B2": stack(lambda l: b(l.ffn.Dense_1)),
        "ln_g": stack(lambda l: torch.stack(
            [l.norm1.weight, l.norm2.weight, l.norm3.weight]).float()),
        "ln_b": stack(lambda l: torch.stack(
            [l.norm1.bias, l.norm2.bias, l.norm3.bias]).float()),
        "head_w": torch.cat([w(h) for h in heads]).contiguous(),
        "head_b": torch.cat([b(h) for h in heads]).contiguous(),
    }


def _layer_norm(x32, g, b, eps=1e-5):
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    return (x32 - mu) * torch.rsqrt(torch.clamp(var, min=0.0) + eps) * g + b


@torch.no_grad()
def decode_step_reference(
    t: int,
    frame: torch.Tensor,  # (B, n_mels) fp32 — previous output frame (go at t=0)
    pe_row: torch.Tensor,  # (1, D) fp32 — alpha * PE[t]
    cross_bias: torch.Tensor,  # (B, Tp) fp32 additive key bias
    self_k: torch.Tensor,  # (L, H, B, n_pos, dh) — positions < t are valid
    self_v: torch.Tensor,
    cross_k: torch.Tensor,  # (L, H, B, Tp, dh)
    cross_v: torch.Tensor,
    packed: dict,
    with_attn_pos: bool = False,
):
    """Plain PyTorch version of the kernel, op for op as the TPU ``_kernel``.

    Pure: returns (y (B, n_mels*r + r) fp32, k_new (L, H, B, dh),
    v_new (L, H, B, dh)) and, with ``with_attn_pos``, the last layer's
    head-averaged expected cross-attention position (B, 1) fp32.  Products
    of ``dtype`` operands are summed in fp32, as
    ``preferred_element_type=float32`` does.
    """
    n_layers, n_heads, b, n_pos, dh = self_k.shape
    d = n_heads * dh
    dtype = packed["pw1"].dtype
    scale = dh ** -0.5
    p = packed

    def dot(a, w):  # w (out, in)
        return a.to(dtype).float() @ w.float().t()

    x = frame.to(dtype)
    x = torch.relu(dot(x, p["pw1"]) + p["pb1"].float())
    x = torch.relu(dot(x, p["pw2"]) + p["pb2"].float())
    x = (x + pe_row.float()).to(dtype)  # (B, D)

    k_new = torch.empty((n_layers, n_heads, b, dh), dtype=self_k.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    pos_mask = torch.arange(n_pos, device=x.device) < t
    col = torch.arange(cross_k.shape[3], device=x.device, dtype=torch.float32)
    pos = None

    for li in range(n_layers):
        # ---------------- self-attention over the cached prefix + current
        resid = x.float()
        qkv = dot(x, p["sWqkv"][li]) + p["sbqkv"][li].float()  # (B, 3D)
        q = (qkv[:, :d] * scale).reshape(b, n_heads, dh)
        kn = qkv[:, d:2 * d].reshape(b, n_heads, dh)
        vn = qkv[:, 2 * d:].reshape(b, n_heads, dh)
        k_new[li] = kn.transpose(0, 1).to(self_k.dtype)
        v_new[li] = vn.transpose(0, 1).to(self_v.dtype)
        qb = q.to(dtype).float()
        s = torch.einsum("bhd,hbpd->bhp", qb, self_k[li].float())
        s = torch.where(pos_mask, s, torch.full_like(s, NEG_INF))
        s_cur = (q * kn).sum(-1, keepdim=True)  # (B, H, 1) fp32
        m = torch.maximum(s.max(-1, keepdim=True).values, s_cur)
        e = torch.exp(s - m)
        e_cur = torch.exp(s_cur - m)
        denom = e.sum(-1, keepdim=True) + e_cur
        ctx = torch.einsum("bhp,hbpd->bhd", e.to(dtype).float(), self_v[li].float())
        ctx = (ctx + e_cur * vn) / denom
        o = dot(ctx.reshape(b, d), p["sWo"][li]) + p["sbo"][li].float()
        x32 = _layer_norm(resid + o, p["ln_g"][li, 0], p["ln_b"][li, 0])
        x = x32.to(dtype)

        # ---------------- cross-attention over the encoder memory
        resid = x32
        q = ((dot(x, p["cWq"][li]) + p["cbq"][li].float()) * scale).reshape(b, n_heads, dh)
        s = torch.einsum("bhd,hbpd->bhp", q.to(dtype).float(), cross_k[li].float())
        s = s + cross_bias.float()[:, None, :]
        e = torch.exp(s - s.max(-1, keepdim=True).values)
        denom_c = e.sum(-1, keepdim=True)
        ctx = torch.einsum("bhp,hbpd->bhd", e.to(dtype).float(), cross_v[li].float()) / denom_c
        o = dot(ctx.reshape(b, d), p["cWo"][li]) + p["cbo"][li].float()
        if with_attn_pos and li == n_layers - 1:
            pos = ((e / denom_c) * col).sum(-1).sum(-1, keepdim=True) / n_heads
        x32 = _layer_norm(resid + o, p["ln_g"][li, 1], p["ln_b"][li, 1])
        x = x32.to(dtype)

        # ---------------- FFN
        h1 = torch.relu(dot(x, p["W1"][li]) + p["B1"][li].float())
        h2 = dot(h1, p["W2"][li]) + p["B2"][li].float()
        x32 = _layer_norm(x32 + h2, p["ln_g"][li, 2], p["ln_b"][li, 2])
        x = x32.to(dtype)

    y = dot(x, p["head_w"]) + p["head_b"].float()
    return (y, k_new, v_new) + ((pos,) if with_attn_pos else ())


def _packed_shapes(n_layers: int, d: int, d_ffn: int, n_mels: int, d_out: int) -> dict:
    """Shape of every packed weight (``pack_decode_weights``'s layout)."""
    L = n_layers
    return {
        "pw1": (d, n_mels), "pb1": (d,), "pw2": (d, d), "pb2": (d,),
        "sWqkv": (L, 3 * d, d), "sbqkv": (L, 3 * d), "sWo": (L, d, d), "sbo": (L, d),
        "cWq": (L, d, d), "cbq": (L, d), "cWo": (L, d, d), "cbo": (L, d),
        "W1": (L, d_ffn, d), "B1": (L, d_ffn), "W2": (L, d, d_ffn), "B2": (L, d),
        "ln_g": (L, 3, d), "ln_b": (L, 3, d), "head_w": (d_out, d), "head_b": (d_out,),
    }


def _check_cuda_args(frame, pe_row, cross_bias, self_k, self_v, cross_k, cross_v, packed):
    """Raise unless every tensor is what the kernel reads: dtype, shape,
    contiguity, widths its 16-byte vectors tile, and the caches' device.
    The C entry point checks the rest (shared memory per block, the plan)."""
    _check_fixed_args(self_k, self_v, cross_k, cross_v, packed)
    _check_step_args(frame, pe_row, cross_bias, self_k, cross_k.shape[3], packed)


def _check_fixed_args(self_k, self_v, cross_k, cross_v, packed):
    """The part of ``_check_cuda_args`` a prepared step checks once: the
    caches and the packed weights."""
    dtype = packed["pw1"].dtype
    n_layers, n_heads, b, n_pos, dh = self_k.shape
    tp = cross_k.shape[3]
    d = n_heads * dh
    d_ffn, n_mels, d_out = packed["W1"].shape[1], packed["pw1"].shape[1], packed["head_w"].shape[0]
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_step kernel takes float32 or bfloat16 weights, got {dtype}")
    widths = (d, d_ffn, n_mels, dh)
    groups = dh // 4
    if not (1 <= b <= MAX_BATCH and all(k % 8 == 0 for k in widths)
            and groups & (groups - 1) == 0 and groups <= 32):
        raise ValueError(f"decode_step kernel takes 1 <= B <= {MAX_BATCH}, widths that are "
                         f"multiples of 8 and dh/4 a power of two <= 32; got B={b}, "
                         f"(d, d_ffn, n_mels, dh)={widths}")
    expect = {
        "self_k": (self_k, dtype, tuple(self_k.shape)),
        "self_v": (self_v, dtype, tuple(self_k.shape)),
        "cross_k": (cross_k, dtype, (n_layers, n_heads, b, tp, dh)),
        "cross_v": (cross_v, dtype, (n_layers, n_heads, b, tp, dh)),
    }
    for k, shape in _packed_shapes(n_layers, d, d_ffn, n_mels, d_out).items():
        expect[k] = (packed[k], torch.float32 if k.startswith("ln_") else dtype, shape)
    _check_tensors(expect, self_k.device)


def _check_step_args(frame, pe_row, cross_bias, self_k, tp, packed):
    """What changes from step to step: the fed-back frame (its rows may lie
    apart, as a slice of the decode's frame buffer), alpha*PE[t] and the
    cross bias."""
    b, n_mels, d = self_k.shape[2], packed["pw1"].shape[1], packed["pw1"].shape[0]
    if frame.dtype != torch.float32 or tuple(frame.shape) != (b, n_mels) or frame.stride(1) != 1:
        raise ValueError(f"decode_step: frame must be float32 of shape {(b, n_mels)} with "
                         f"unit column stride, got {frame.dtype} {tuple(frame.shape)} "
                         f"strides {frame.stride()}")
    _check_tensors({"pe_row": (pe_row, torch.float32, (1, d)),
                    "cross_bias": (cross_bias, torch.float32, (b, tp))}, self_k.device)
    if frame.device != self_k.device:
        raise ValueError(f"decode_step: frame is on {frame.device}, caches on {self_k.device}")


def _check_tensors(expect: dict, device) -> None:
    for name, (x, dt, shape) in expect.items():
        if x.dtype != dt or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"decode_step: {name} must be a contiguous {dt} of shape {shape}, "
                             f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    for name, (x, _, _) in expect.items():
        if x.device.type != "cuda" or x.device != device:
            raise ValueError(f"decode_step: {name} is on {x.device}, caches on {device}")


# ---------------------------------------------------------------- the plan
#
# What the C side is handed besides pointers: the output columns each block
# of a cluster owns in every matrix-vector stage, cut into weight pieces,
# where each piece lies in the block's shared-memory ring and when it is
# copied, the attention chunks, the rows a cluster decodes, and the
# shared-memory layout.  All of it is computed here, so the CPU tests reach
# it; the kernel only checks what it is given.

CLUSTER = 16  # blocks of a cluster, as a rule (Config::cluster in the CUDA source)
# cluster sizes tried in turn for one row a cluster (``card_plan``)
CLUSTER_SIZES = (16, 12, 8)
MAX_CLUSTER = 16  # kMaxCluster
THREADS = 512  # threads of a block (kThreads)
WARPS = THREADS // 32
SMEM_LIMIT = 232_448  # dynamic shared memory a block may opt in to on Hopper (227 KB)
PIECE_BYTES = 32 * 1024  # a weight piece, at most (unless one column is larger)
MAX_PIECES = 512  # kMaxPieces
# keys of an attention chunk, at least: a bf16 block reads 256 cache rows in
# one batch of loads (kUnroll x 64 rows), so shorter chunks only add partials
# (and one chunk a (row, head) saves the attention's second barrier)
MIN_CHUNK = 256
# the kernel's shared-memory buffers, in the order of its Buffer enum
SMEM_BUFFERS = ("stages", "pieces", "mbar", "red", "bias", "ln", "ra", "rb", "o", "q", "kv",
                "act", "xs", "pm", "pl", "ppos", "pacc", "mloc", "posh", "part", "scores", "ring")


def gemv_stages(n_layers: int, d: int, d_ffn: int, n_mels: int, d_out: int) -> list:
    """(name, N columns, K depth) of every matrix-vector stage of a step, in
    the kernel's order (``stage_w`` in the CUDA source)."""
    stages = [("prenet1", d, n_mels), ("prenet2", d, d)]
    for li in range(n_layers):
        stages += [(f"qkv{li}", 3 * d, d), (f"self_out{li}", d, d), (f"cross_q{li}", d, d),
                   (f"cross_out{li}", d, d), (f"ffn1_{li}", d_ffn, d), (f"ffn2_{li}", d, d_ffn)]
    stages.append(("head", d_out, d))
    return stages


def split_columns(n: int, n_blocks: int, first: int = 0) -> list:
    """[col0, col1) of each block for n columns: n // n_blocks each, one more
    for n % n_blocks blocks starting at block ``first`` (so that the extra
    columns of successive stages land on different blocks)."""
    q, r = divmod(n, n_blocks)
    sizes = [q + ((g - first) % n_blocks < r) for g in range(n_blocks)]
    out, at = [], 0
    for size in sizes:
        out.append((at, at + size))
        at += size
    return out


def ring_placement(piece_bytes: list, ring_bytes: int) -> list:
    """(ring offset, issue after) of one block's weight pieces, placed one
    after another in a ring of ``ring_bytes`` (a piece that would run past
    the end starts again at 0).  A piece is copied at kernel start (issue
    after -1) or once the piece that last used any of its bytes has been
    used; "issue after" never decreases along the pieces."""
    out, placed, at = [], [], 0  # placed: (piece, start, end)
    for i, nb in enumerate(piece_bytes):
        if nb > ring_bytes:
            raise ValueError(f"a weight piece of {nb} bytes exceeds the {ring_bytes}-byte ring")
        if at + nb > ring_bytes:
            at = 0
        after = max((i2 for i2, a, e in placed if a < at + nb and at < e), default=-1)
        if out and after < out[-1][1]:
            after = out[-1][1]
        placed.append((i, at, at + nb))
        out.append((at, after))
        at += nb
    return out


def attn_chunks(n_keys: int, rows: int, n_heads: int, n_blocks: int = CLUSTER,
                min_chunk: int = MIN_CHUNK) -> tuple:
    """(keys per chunk, chunks) that cut the keys of every (row, head) of a
    cluster's ``rows`` rows: as many chunks as leave every block at most one
    (row, head, chunk) item, none shorter than ``min_chunk`` keys unless the
    keys are fewer.  Chunk c covers [c * len, min((c + 1) * len, n_keys)).
    (0, 0) for no keys."""
    if n_keys <= 0:
        return 0, 0
    nc = max(1, min(n_blocks // (rows * n_heads), -(-n_keys // min_chunk)))
    length = -(-n_keys // nc)
    return length, -(-n_keys // length)


def chunks_max(rows: int, n_heads: int, n_blocks: int = CLUSTER) -> int:
    """The most chunks per (row, head) ``attn_chunks`` gives."""
    return max(1, n_blocks // (rows * n_heads))


def decode_plan(n_layers: int, d: int, d_ffn: int, n_mels: int, d_out: int, rows: int,
                n_heads: int, n_pos: int, tp: int, itemsize: int, cluster: int = CLUSTER):
    """The kernel's plan for clusters of ``rows`` batch rows: an int32 array
    (3 + 6 L, cluster, 4) of (first piece, end piece, bias offset, 0) per
    stage and block, an int32 array (pieces, cluster, 4) of (first column,
    end column, ring offset, issue after) per weight piece and block (a
    block with fewer pieces pads with pieces never issued), and the
    shared-memory layout: the byte offset of every buffer of
    ``SMEM_BUFFERS``, ``ring_bytes`` and ``smem_bytes``.  Raises when a
    block's buffers or a piece do not fit."""
    stages = gemv_stages(n_layers, d, d_ffn, n_mels, d_out)
    cols, first = [], 0
    for _, n, _ in stages:
        cols.append(split_columns(n, cluster, first))
        first = (first + n % cluster) % cluster
    # every block's pieces: (stage, col0, col1, bytes)
    pieces = []
    for g in range(cluster):
        mine = []
        for s, (_, _, k) in enumerate(stages):
            c0, c1 = cols[s][g]
            step = max(1, PIECE_BYTES // (k * itemsize))
            mine += [(s, a, min(a + step, c1), (min(a + step, c1) - a) * k * itemsize)
                     for a in range(c0, c1, step)]
        pieces.append(mine)
    n_pieces = max(len(p) for p in pieces)
    if n_pieces > MAX_PIECES:
        raise ValueError(f"decode_step: {n_pieces} weight pieces a block, over {MAX_PIECES}")
    need = max(sum(p[3] for p in mine) for mine in pieces)
    bias = -(-max(sum(c1 - c0 for c0, c1 in (cols[s][g] for s in range(len(stages))))
                  for g in range(cluster)) // 4) * 4  # a bulk copy moves 16-byte multiples
    layout = decode_smem_layout(rows, n_layers, n_heads, d // n_heads, d_ffn, n_mels, n_pos, tp,
                                itemsize, len(stages), n_pieces, bias, need, cluster)
    stage_rows = np.zeros((len(stages), cluster, 4), np.int32)
    piece_rows = np.zeros((n_pieces, cluster, 4), np.int32)
    piece_rows[:, :, 3] = 1 << 30  # padding: never issued
    for g, mine in enumerate(pieces):
        place = ring_placement([p[3] for p in mine], layout["ring_bytes"])
        bias_at = 0
        for s in range(len(stages)):
            idx = [i for i, p in enumerate(mine) if p[0] == s]
            lo = idx[0] if idx else (stage_rows[s - 1, g, 1] if s else 0)
            stage_rows[s, g] = (lo, idx[-1] + 1 if idx else lo, bias_at, 0)
            bias_at += cols[s][g][1] - cols[s][g][0]
        for i, (p, (off, after)) in enumerate(zip(mine, place)):
            piece_rows[i, g] = (p[1], p[2], off, after)
    return stage_rows, piece_rows, layout


def stage_biases(packed: dict, n_layers: int) -> list:
    """The bias of every matrix-vector stage, in ``gemv_stages`` order."""
    out = [packed["pb1"], packed["pb2"]]
    for li in range(n_layers):
        out += [packed[k][li] for k in ("sbqkv", "sbo", "cbq", "cbo", "B1", "B2")]
    return out + [packed["head_b"]]


def bias_table(biases: list, stage_rows, piece_rows, n_bias: int) -> torch.Tensor:
    """(cluster, n_bias) fp32: each block's biases of its columns, stage
    after stage at the stage rows' bias offsets (what the kernel copies
    into its kBufBias)."""
    cluster = stage_rows.shape[1]
    table = torch.zeros((cluster, n_bias), dtype=torch.float32)
    for g in range(cluster):
        for s, bias in enumerate(biases):
            first, end, at, _ = (int(v) for v in stage_rows[s, g])
            if end > first:
                c0, c1 = int(piece_rows[first, g, 0]), int(piece_rows[end - 1, g, 1])
                table[g, at:at + c1 - c0] = bias[c0:c1].float().cpu()
    return table


def decode_smem_layout(rows: int, n_layers: int, n_heads: int, dh: int, d_ffn: int, n_mels: int,
                       n_pos: int, tp: int, itemsize: int, n_stages: int, n_pieces: int,
                       bias_floats: int, ring_need: int, cluster: int = CLUSTER) -> dict:
    """Byte offsets of the kernel's shared-memory buffers (``SMEM_BUFFERS``;
    the CUDA source's Buffer enum says what each holds), 16-byte aligned,
    for clusters of ``rows`` rows; the ring takes what is left of
    ``SMEM_LIMIT``, at most ``ring_need``."""
    d = n_heads * dh
    rh, ncm = rows * n_heads, chunks_max(rows, n_heads, cluster)
    items = -(-rh * ncm // cluster)  # (row, head, chunk) items a block, at most
    max_keys = max(n_pos, tp)
    floats = {
        "red": 2 * rows * WARPS, "bias": bias_floats, "ln": 2 * 6 * d,
        "ra": rows * d, "rb": rows * d, "o": rows * d, "q": rows * d,
        "kv": 2 * rows * d, "act": rows * max(d, d_ffn), "xs": rows * max(d, n_mels),
        "pm": rh * ncm, "pl": rh * ncm, "ppos": rh * ncm, "pacc": rh * ncm * dh,
        "mloc": items, "posh": rh, "part": THREADS * (16 // itemsize) + THREADS + dh,
        "scores": items * max_keys,
    }
    sizes = {"stages": 16 * n_stages, "pieces": 16 * n_pieces, "mbar": 8 * (n_pieces + n_layers + 1),
             **{k: 4 * v for k, v in floats.items()}}
    out, at = {}, 0
    for name in SMEM_BUFFERS[:-1]:
        out[name] = at
        at += -(-sizes[name] // 16) * 16
    out["ring"] = at
    out["n_bias"] = bias_floats
    out["ring_bytes"] = min((SMEM_LIMIT - at) // 16 * 16, -(-ring_need // 16) * 16)
    out["smem_bytes"] = at + max(out["ring_bytes"], 0)
    if out["ring_bytes"] < PIECE_BYTES and out["ring_bytes"] < ring_need:
        raise ValueError(f"decode_step: the kernel's buffers take {at} bytes of shared memory, "
                         f"too much of the {SMEM_LIMIT} a block may have")
    return out


def rows_per_cluster(b: int, max_clusters) -> int:
    """Rows R a cluster decodes: the smallest divisor of b whose b / R
    clusters the card holds at once (``max_clusters(R)``, 0 where R does not
    fit a block); the smallest that fits when none is held at once."""
    fits = [r for r in range(1, b + 1) if b % r == 0 and max_clusters(r) > 0]
    if not fits:
        raise ValueError(f"decode_step: no rows per cluster fits B={b}")
    return next((r for r in fits if b // r <= max_clusters(r)), fits[0])


def card_plan(n_layers: int, d: int, d_ffn: int, n_mels: int, d_out: int, b: int, n_heads: int,
              n_pos: int, tp: int, dtype: torch.dtype) -> tuple:
    """(blocks a cluster, rows per cluster, ``decode_plan``) for B = b on
    the current card: one row a cluster with the first size of
    ``CLUSTER_SIZES`` whose b clusters the card holds at once; else clusters
    of ``CLUSTER`` blocks and the rows from ``rows_per_cluster``."""
    lib = _lib()
    is_bf16 = int(dtype == torch.bfloat16)
    itemsize = torch.empty((), dtype=dtype).element_size()

    def plan(rows, cluster):
        return decode_plan(n_layers, d, d_ffn, n_mels, d_out, rows, n_heads, n_pos, tp,
                           itemsize, cluster)

    def max_clusters(rows, cluster=CLUSTER):  # 0 where the plan does not fit
        try:
            smem = plan(rows, cluster)[2]["smem_bytes"]
        except ValueError:
            return 0
        return lib.tts_decode_step_max_clusters(is_bf16, rows, smem, cluster)

    for cluster in CLUSTER_SIZES:
        if max_clusters(1, cluster) >= b:
            return cluster, 1, plan(1, cluster)
    rows = rows_per_cluster(b, max_clusters)
    return CLUSTER, rows, plan(rows, CLUSTER)


# ------------------------------------------------------------- the launch

class _StepConfig(ctypes.Structure):
    """The CUDA source's ``Config``, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "cluster", "B", "R", "L", "H", "dh", "F", "n_mels", "d_out", "n_pos", "tp",
        "cross_chunk", "cross_nc", "nc_max", "max_keys", "n_pieces", "n_bias", "smem_bytes")] + [
        ("off", ctypes.c_int * len(SMEM_BUFFERS)),
        ("first_piece", (ctypes.c_int * 2) * MAX_CLUSTER), ("scale", ctypes.c_float),
        ("w", ctypes.c_void_p * len(_PACK_ORDER)),
        ("stages", ctypes.c_void_p), ("pieces", ctypes.c_void_p), ("bias", ctypes.c_void_p)]


def _lib():
    from transformertts_tpu_torch import _build

    lib = _build.load("decode_step")
    if not getattr(lib, "_argtypes_set", False):
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.tts_decode_step.argtypes = [p, i, i, i, i, p, i] + [p] * 12
        lib.tts_decode_step.restype = i
        lib.tts_decode_step_max_clusters.argtypes = [i, i, i, i]
        lib.tts_decode_step_config_bytes.restype = ctypes.c_long
        if lib.tts_decode_step_config_bytes() != ctypes.sizeof(_StepConfig):
            raise RuntimeError("decode_step: _StepConfig does not mirror the CUDA Config")
        lib._argtypes_set = True
    return lib


def _current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class DecodeStep:
    """One decoder step on the GPU, prepared for fixed caches and weights.

    Built once per decode (per chunk of rows): it checks the caches and the
    packed weights, picks the rows a cluster decodes, computes the plan and
    uploads it, allocates the outputs and fills the kernel's ``Config``.
    Each call is then one C call and one kernel launch on the stream that
    is current at the call:

        step = DecodeStep(self_k, self_v, cross_k, cross_v, packed, with_attn_pos)
        y, k_new, v_new[, pos] = step(t, frame, pe_row, cross_bias)

    The results are the step's own buffers, overwritten by its next call.
    The new K/V rows are also written into ``self_k`` / ``self_v`` at ``t``.
    """

    def __init__(self, self_k, self_v, cross_k, cross_v, packed, with_attn_pos: bool = False):
        _check_fixed_args(self_k, self_v, cross_k, cross_v, packed)
        lib = _lib()
        n_layers, n_heads, b, n_pos, dh = self_k.shape
        tp, dev = cross_k.shape[3], self_k.device
        d, d_ffn = n_heads * dh, packed["W1"].shape[1]
        n_mels, d_out = packed["pw1"].shape[1], packed["head_w"].shape[0]
        is_bf16 = int(packed["pw1"].dtype == torch.bfloat16)
        cluster, rows, (stage_rows, piece_rows, layout) = card_plan(
            n_layers, d, d_ffn, n_mels, d_out, b, n_heads, n_pos, tp, packed["pw1"].dtype)
        # each rank's rows contiguous, for one bulk copy each
        self._stages = torch.from_numpy(stage_rows.transpose(1, 0, 2).copy()).to(dev)
        self._pieces = torch.from_numpy(piece_rows.transpose(1, 0, 2).copy()).to(dev)
        self._bias = bias_table(stage_biases(packed, n_layers), stage_rows, piece_rows,
                                layout["n_bias"]).to(dev)
        self.y = torch.empty((b, d_out), dtype=torch.float32, device=dev)
        self.k_new = torch.empty((n_layers, n_heads, b, dh), dtype=self_k.dtype, device=dev)
        self.v_new = torch.empty_like(self.k_new)
        self.pos = torch.empty((b, 1), dtype=torch.float32, device=dev) if with_attn_pos else None
        cross_chunk, cross_nc = attn_chunks(tp, rows, n_heads, cluster)
        self._self_chunks = [attn_chunks(t, rows, n_heads, cluster) for t in range(n_pos)]
        self.layout, self.rows, self.cluster = layout, rows, cluster
        self.blocks = b // rows * cluster
        self._cfg = _StepConfig(
            cluster=cluster, B=b, R=rows, L=n_layers, H=n_heads, dh=dh, F=d_ffn, n_mels=n_mels, d_out=d_out,
            n_pos=n_pos, tp=tp, cross_chunk=cross_chunk, cross_nc=cross_nc,
            nc_max=chunks_max(rows, n_heads, cluster), max_keys=max(n_pos, tp),
            n_pieces=piece_rows.shape[0], n_bias=layout["n_bias"],
            smem_bytes=layout["smem_bytes"],
            off=(ctypes.c_int * len(SMEM_BUFFERS))(*[layout[k] for k in SMEM_BUFFERS]),
            first_piece=((ctypes.c_int * 2) * MAX_CLUSTER)(
                *[(ctypes.c_int * 2)(*piece_rows[0, g, :2]) for g in range(cluster)]),
            scale=dh ** -0.5,
            w=(ctypes.c_void_p * len(_PACK_ORDER))(*[packed[k].data_ptr() for k in _PACK_ORDER]),
            stages=self._stages.data_ptr(), pieces=self._pieces.data_ptr(),
            bias=self._bias.data_ptr())
        self._keep = (self_k, self_v, cross_k, cross_v, packed)  # the pointers stay valid
        self._is_bf16 = is_bf16
        self._fixed = (self_k.data_ptr(), self_v.data_ptr(), cross_k.data_ptr(),
                       cross_v.data_ptr())
        self._call = lib.tts_decode_step
        self._b, self._n_pos, self._tp = b, n_pos, tp
        self._shape = (n_layers, n_heads, dh, d_ffn)

    def __call__(self, t: int, frame, pe_row, cross_bias, out=None, timeline=None):
        """The step at position ``t``.  ``out``: (y, k_new, v_new, pos or
        None) to write into instead of the step's own buffers.
        ``timeline``: an int64 tensor from ``timeline_buffer`` that the
        kernel fills with global-timer stamps (``stage_times`` reads it)."""
        if not 0 <= t < self._n_pos:
            raise ValueError(f"t={t} outside the cache of {self._n_pos} positions")
        _check_step_args(frame, pe_row, cross_bias, self._keep[0], self._tp, self._keep[4])
        y, k_new, v_new, pos = out if out is not None else (self.y, self.k_new, self.v_new,
                                                            self.pos)
        chunk, nc = self._self_chunks[t]
        rc = self._call(
            ctypes.byref(self._cfg), self._is_bf16, t, chunk, nc,
            frame.data_ptr(), frame.stride(0), pe_row.data_ptr(), cross_bias.data_ptr(),
            *self._fixed, y.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            pos.data_ptr() if pos is not None else None,
            timeline.data_ptr() if timeline is not None else None,
            _current_stream(self.y.device))
        if rc != 0:
            n_layers, n_heads, dh, d_ffn = self._shape
            raise RuntimeError(
                f"decode_step kernel refused or failed to launch (CUDA error {rc}) for "
                f"B={self._b}, L={n_layers}, H={n_heads}, dh={dh}, d_ffn={d_ffn}, "
                f"n_pos={self._n_pos}, Tp={self._tp}, t={t}")
        decode_step.launches += 1
        if self._b > 1:
            decode_step.launches_batched += 1
        return (y, k_new, v_new) + ((pos,) if pos is not None else ())

    def stages(self, t: int) -> list:
        """``step_stages`` of a call at position t."""
        return step_stages(self._shape[0], self._self_chunks[t][1], self._cfg.cross_nc)

    def timeline_buffer(self) -> torch.Tensor:
        """Room for one call's stamps: per block the kernel's start, the
        arrival at and release from each cluster barrier, and its end."""
        return torch.zeros((self.blocks, 6 + 20 * self._shape[0]), dtype=torch.int64,
                           device=self.y.device)


def step_stages(n_layers: int, self_nc: int, cross_nc: int) -> list:
    """Names of the kernel's stages, in order (a cluster barrier between
    each two), for ``self_nc`` / ``cross_nc`` key chunks a (row, head): an
    attention of one chunk is one stage, of several two (scores and their
    max, then the values against the global max)."""
    def attn(kind, nc, li):
        if nc == 0:
            return []
        return [f"{kind}_attn{li}"] if nc == 1 else [f"{kind}_scores{li}", f"{kind}_values{li}"]

    names = ["prenet1", "prenet2"]
    for li in range(n_layers):
        names += [f"qkv{li}", *attn("self", self_nc, li), f"self_out{li}", f"cross_q{li}",
                  *attn("cross", cross_nc, li), f"cross_out{li}", f"ffn1_{li}", f"ffn2_{li}"]
    return names + ["head"]


def stage_times(timeline: torch.Tensor, n_barriers: int) -> list:
    """(work us, wait us) of each stage from one call's ``timeline``: the
    work is the slowest block's time from the previous release (or the
    kernel's start) to its arrival; the wait the time from that last
    arrival to the latest release.  The last stage has no wait."""
    stamps = timeline.cpu().to(torch.float64) / 1e3
    start = stamps[:, 0]
    out = []
    for i in range(n_barriers + 1):
        arrive = stamps[:, 1 + 2 * i]
        work = float((arrive - start).max())
        if i == n_barriers:
            out.append((work, 0.0))
            break
        release = stamps[:, 2 + 2 * i]
        out.append((work, float(release.max() - arrive.max())))
        start = release
    return out


_prepared: "OrderedDict[tuple, DecodeStep]" = OrderedDict()  # decode_step's recent steps
_PREPARED_MAX = 8


def _prepared_step(self_k, self_v, cross_k, cross_v, packed, with_attn_pos) -> DecodeStep:
    """A ``DecodeStep`` for these tensors on the current stream, reused
    while the same tensors (pointers, shapes, dtypes) come back."""
    key = (_current_stream(self_k.device), with_attn_pos,
           *[(x.data_ptr(), x.shape, x.dtype, x.is_contiguous())
             for x in (self_k, self_v, cross_k, cross_v)],
           *[packed[k].data_ptr() for k in _PACK_ORDER])
    step = _prepared.get(key)
    if step is None:
        step = DecodeStep(self_k, self_v, cross_k, cross_v, packed, with_attn_pos)
        _prepared[key] = step
        if len(_prepared) > _PREPARED_MAX:
            _prepared.popitem(last=False)
    else:
        _prepared.move_to_end(key)
    return step


@torch.no_grad()
def decode_step(
    t: int,
    frame: torch.Tensor,
    pe_row: torch.Tensor,
    cross_bias: torch.Tensor,
    self_k: torch.Tensor,
    self_v: torch.Tensor,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
    packed: dict,
    with_attn_pos: bool = False,
):
    """One decoder step; arguments and results as ``decode_step_reference``.

    Writes the new K/V rows into ``self_k``/``self_v`` at position ``t``
    in place.  On CUDA tensors it launches the kernel once (or raises),
    through a ``DecodeStep`` kept for these tensors, into fresh outputs; on
    CPU tensors it runs the plain version.
    """
    n_layers, n_heads, b, n_pos, dh = self_k.shape
    if not 0 <= t < n_pos:
        raise ValueError(f"t={t} outside the cache of {n_pos} positions")
    if self_k.device.type == "cpu":
        out = decode_step_reference(
            t, frame, pe_row, cross_bias, self_k, self_v, cross_k, cross_v,
            packed, with_attn_pos,
        )
        self_k[:, :, :, t] = out[1]
        self_v[:, :, :, t] = out[2]
        return out
    step = _prepared_step(self_k, self_v, cross_k, cross_v, packed, with_attn_pos)
    dev = self_k.device
    y = torch.empty((b, packed["head_w"].shape[0]), dtype=torch.float32, device=dev)
    k_new = torch.empty((n_layers, n_heads, b, dh), dtype=self_k.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    pos = torch.empty((b, 1), dtype=torch.float32, device=dev) if with_attn_pos else None
    return step(t, frame, pe_row, cross_bias, out=(y, k_new, v_new, pos))


decode_step.launches = 0  # kernel launches (B = 1 and B > 1)
decode_step.launches_batched = 0  # of which with B > 1 (the batched TPU kernel's role)
