"""What the verify kernel of speculative decoding is handed besides pointers,
and plain models of its sums, on the CPU.

The verify kernel (``ops/csrc/decode_step_verify.cu``) runs the decoder
step's chain for the K positions of a pass in one cluster of 16 blocks.  It
only checks what ``ops/decode_step.py`` computes for it: the plan (each
block's columns of every matrix-vector stage, cut into weight pieces of
rows padded by ``verify_row_pad``), the attention items (head, chunk) and
the shared-memory layout.  These tests hold them to what the kernel assumes
at ``Config()`` widths for K 2..8 and ``configs/paper.yaml`` widths for K <=
4, and model the kernel's arithmetic plainly:

- the bf16 products as the tensor cores take them (16-wide depth steps
  summed in order within a depth slice, the slices added in order,
  ``tile_split``), against ``decode_verify_reference`` within the kernel's
  bf16 tolerance (2e-2 of max(1, max|reference|), as ``chip_smoke.py``'s
  ``TOL``: both round the same quantities to bf16 and differ in the order of
  fp32 sums);
- the fp32 transposed butterfly (``transposed_sum``), bit for bit against a
  per-row shuffle tree (``warp_sum``).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from transformertts_tpu_torch.config import Config, load_config, tiny_config
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.models.masks import NEG_INF
from transformertts_tpu_torch.ops.decode_step import (
    CLUSTER,
    TILE,
    TILE_COLS_MAX,
    VERIFY_PAD,
    WARPS,
    _layer_norm,
    decode_verify_reference,
    gemv_stages,
    pack_decode_weights,
    pack_verify_weights,
    tile_split,
    verify_chunks,
    verify_piece_cols,
    verify_plan,
    verify_row_pad,
)

WIDTHS = {
    "config": Config().model,
    "paper": load_config(Path(__file__).resolve().parents[1] / "configs" / "paper.yaml").model,
}
CASES = [("config", k) for k in range(2, 9)] + [("paper", k) for k in range(2, 5)]
TOL_BF16 = 2e-2


def _plan(m, k, itemsize, n_pos=400, tp=64):
    r = m.reduction_factor
    args = (m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels, m.n_mels * r + r)
    return (*verify_plan(*args, k, r, m.decoder_n_head, n_pos + k, tp, itemsize),
            gemv_stages(*args))


def _pieces(stage_rows, piece_rows, s, g):
    first, end = int(stage_rows[s, g, 0]), int(stage_rows[s, g, 1])
    return [tuple(int(v) for v in piece_rows[i, g]) for i in range(first, end)]


# ------------------------------------------------------------------ the plan

@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("widths,k", CASES)
def test_plan_computes_every_column_and_position_once(widths, k, itemsize):
    """Every (stage column, position) pair is computed by one warp of one
    block, over the whole depth once: bf16 by the 16-column tiles of a
    piece and their depth slices (``tile_split``: at most one warp each, the
    slices a partition of the 16-wide steps), fp32 by the warps' column
    pairs (n, n + 16) of a piece, each warp all K positions."""
    stage_rows, piece_rows, layout, stages = _plan(WIDTHS[widths], k, itemsize)
    for s, (_, n, depth) in enumerate(stages):
        done = np.zeros((n, k), np.int64)
        for g in range(CLUSTER):
            for c0, c1, _, _ in _pieces(stage_rows, piece_rows, s, g):
                if itemsize == 2:
                    tiles, slices = tile_split(c1 - c0, depth)
                    assert tiles * slices <= WARPS and c1 - c0 <= TILE_COLS_MAX
                    nk = depth // TILE
                    steps = np.zeros(nk, np.int64)
                    for q in range(slices):
                        steps[q * nk // slices:(q + 1) * nk // slices] += 1
                    assert (steps == 1).all()
                    for tile in range(tiles):
                        cols = np.arange(c0 + TILE * tile, min(c0 + TILE * (tile + 1), c1))
                        done[cols] += 1
                else:
                    for warp in range(WARPS):
                        for n0 in range(c0 + warp, c1, 2 * WARPS):
                            done[[c for c in (n0, n0 + WARPS) if c < c1]] += 1
        assert (done == 1).all(), (stages[s][0], np.unique(done))


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("widths,k", CASES)
def test_plan_fits_and_pieces_take_whole_tiles(widths, k, itemsize):
    """The layout fits a block with a ring that holds the largest piece;
    bf16 pieces are whole 16-column tiles (but a block's last of a stage, or
    where one tile is over 64 KB), of padded rows."""
    m = WIDTHS[widths]
    for n_pos, tp in ((400, 64), (1500, 192)):
        stage_rows, piece_rows, layout, stages = _plan(m, k, itemsize, n_pos, tp)
        assert layout["smem_bytes"] <= 232_448
        pad = verify_row_pad(itemsize)
        for s, (_, _, depth) in enumerate(stages):
            step = verify_piece_cols(depth, itemsize)
            for g in range(CLUSTER):
                pieces = _pieces(stage_rows, piece_rows, s, g)
                for i, (c0, c1, off, _) in enumerate(pieces):
                    assert (c1 - c0) * (depth + pad) * itemsize <= layout["ring_bytes"]
                    assert off % 16 == 0 and off + (c1 - c0) * (depth + pad) * itemsize <= (
                        layout["ring_bytes"])
                    assert c1 - c0 == step or i == len(pieces) - 1
                    if itemsize == 2 and step >= TILE:
                        assert step % TILE == 0


def test_verify_row_pad_and_piece_cols():
    """bf16 rows carry 8 more elements (16 bytes), fp32 none; bf16 pieces
    round down to whole tiles (a 64-column stage of ``Config()`` in one
    piece) and take one tile of up to 64 KB."""
    assert (verify_row_pad(2), verify_row_pad(4), VERIFY_PAD) == (8, 0, 8)
    assert verify_piece_cols(256, 2) == 64  # 69 rows of 528 bytes fit 36 KB: 4 tiles
    assert verify_piece_cols(1024, 2) == 16  # 17 fit: one tile
    assert verify_piece_cols(2048, 2) == 8  # a tile would take 66 KB
    assert verify_piece_cols(80, 2) == 208
    assert verify_piece_cols(64, 2) == TILE_COLS_MAX
    assert verify_piece_cols(16, 2) == TILE_COLS_MAX
    assert verify_piece_cols(256, 4) == 36


def test_verify_plan_refuses_bf16_widths_off_the_tile():
    m = dataclasses.replace(Config().model, n_mels=72)
    with pytest.raises(ValueError, match="multiples of 16"):
        _plan(m, 4, 2)
    _plan(m, 4, 4)  # fp32 takes them


# -------------------------------------------------------------- attention

@pytest.mark.parametrize("widths,k", [("config", 2), ("config", 8), ("paper", 4)])
def test_attention_items_cover_every_head_and_key_once(widths, k):
    """At every key count of a decode's self-attention (1 .. n_pos - 1) and
    the cross-attention's, the items (head, chunk) cover every (head, key)
    once; each scores all K queries into its own partials ((b H + h) nc +
    chunk: distinct, inside the layout's buffers), chunks no longer than the
    layout's max_keys, items a block no more than its scores buffer holds."""
    m = WIDTHS[widths]
    n_pos, tp, H = 400, 64, m.decoder_n_head
    _, _, layout, _ = _plan(m, k, 2, n_pos, tp)
    items_max = -(-H * layout["nc_max"] // CLUSTER)
    for n_keys in list(range(1, n_pos)) + [tp]:
        length, nc = verify_chunks(n_keys, H)
        assert 1 <= nc <= layout["nc_max"] and length <= layout["max_keys"]
        seen = np.zeros((H, n_keys), np.int64)
        slots = {}
        for item in range(H * nc):
            h, chunk = divmod(item, nc)
            seen[h, chunk * length:min((chunk + 1) * length, n_keys)] += 1
            slots[item % CLUSTER] = slots.get(item % CLUSTER, 0) + 1
        assert (seen == 1).all() and max(slots.values()) <= items_max
        partials = {(b * H + h) * nc + c for b in range(k) for h in range(H) for c in range(nc)}
        assert partials == set(range(k * H * nc))


# ------------------------------------------------ the verify weight layout

def _small_packed(dtype=torch.bfloat16):
    m = dataclasses.replace(tiny_config().model, d_model=64, decoder_n_head=2, decoder_d_ffn=512)
    model = TransformerTTS(m, dtype=dtype, device="cpu", generator=torch.Generator().manual_seed(0))
    return m, pack_decode_weights(model, dtype)


def test_verify_weights_are_a_bijection_of_each_piece():
    """The verify copy is the packed weights with 8 zeros after each row;
    a piece's bulk copy (its rows' bytes, contiguous in the copy) lands each
    (column, depth) element at ring offset + ((n - col0) (K + 8) + k) 2 once,
    and nothing else of the piece is read but padding."""
    m, packed = _small_packed()
    weights = pack_verify_weights(packed)
    fp32 = _small_packed(torch.float32)[1]
    assert pack_verify_weights(fp32) is fp32  # fp32 rows need no padding
    r = m.reduction_factor
    stage_rows, piece_rows, layout, stages = _plan(m, 4, 2)
    names = ["pw1", "pw2"] + [f"{w}/{l}" for l in range(m.decoder_n_layers)
                              for w in ("sWqkv", "sWo", "cWq", "cWo", "W1", "W2")] + ["head_w"]
    for s, ((_, n, depth), name) in enumerate(zip(stages, names)):
        key, _, layer = name.partition("/")
        w = packed[key][int(layer)] if layer else packed[key]
        wp = weights[key][int(layer)] if layer else weights[key]
        assert wp.shape == (n, depth + VERIFY_PAD) and torch.equal(wp[:, :depth], w)
        assert not wp[:, depth:].float().any()
        flat = wp.contiguous().view(torch.int16).numpy().reshape(-1)
        for g in range(CLUSTER):
            for c0, c1, off, _ in _pieces(stage_rows, piece_rows, s, g):
                ring = np.full(layout["ring_bytes"] // 2, -1, np.int64)
                src = flat[c0 * (depth + VERIFY_PAD):c1 * (depth + VERIFY_PAD)]
                ring[off // 2:off // 2 + src.size] = np.arange(src.size)
                cols, ks = np.meshgrid(np.arange(c1 - c0), np.arange(depth), indexing="ij")
                at = off // 2 + cols * (depth + VERIFY_PAD) + ks
                got = ring[at]  # which source element each (column, depth) reads
                assert np.array_equal(got, cols * (depth + VERIFY_PAD) + ks)
                assert np.array_equal(flat[c0 * (depth + VERIFY_PAD) + got],
                                      w[c0:c1].contiguous().view(torch.int16).numpy())
    assert weights["pb1"] is packed["pb1"] and weights["ln_g"] is packed["ln_g"]


def _conflict_free(byte_addrs) -> bool:
    """One shared-memory phase of 16-byte rows: no bank (4-byte word % 32)
    asked for two different words."""
    words = {}
    for a in byte_addrs:
        for w in range(a // 4, a // 4 + 4):
            if words.setdefault(w % 32, w) != w:
                return False
    return True


@pytest.mark.parametrize("widths,k", [("config", 4), ("config", 8), ("paper", 4)])
def test_ldmatrix_reads_are_bank_conflict_free(widths, k):
    """Every 8-row phase of the kernel's ldmatrix loads (A: 16 weight rows
    of a tile from the ring, rows past the piece repeating its last; B: the
    K rows of the bf16 inputs, rows past K repeating row K - 1), at every
    16-wide depth step, falls in distinct banks."""
    stage_rows, piece_rows, layout, stages = _plan(WIDTHS[widths], k, 2)
    for s, (_, _, depth) in enumerate(stages):
        ld = depth + VERIFY_PAD
        for kk in range(depth // TILE):
            for half in (0, 1):  # B: lanes 0-7, then 8-15
                rows = [min(i, k - 1) for i in range(8)]
                assert _conflict_free([(r * ld + 8 * half + kk * TILE) * 2 for r in rows])
        for g in range(CLUSTER):
            for c0, c1, off, _ in _pieces(stage_rows, piece_rows, s, g):
                tiles, _ = tile_split(c1 - c0, depth)
                for tile in range(tiles):
                    for kk in range(depth // TILE):
                        for mat in range(4):  # lanes 8 mat .. 8 mat + 7
                            rows = [min(tile * TILE + i + 8 * (mat & 1), c1 - c0 - 1)
                                    for i in range(8)]
                            addrs = [off + (r * ld + 8 * (mat >> 1) + kk * TILE) * 2 for r in rows]
                            assert _conflict_free(addrs), (s, g, tile, kk, mat)


# ------------------------------------------- the bf16 products, plainly

def _kernel_dot(x, w, b, slices):
    """x (R, K) @ w (N, K)^T + b as the kernel sums it: the products of each
    16-wide depth step summed in fp32, the steps of a depth slice added in
    order, the slices in order (``slices[n]`` those of column n), then b."""
    rows, depth = x.shape
    nk = depth // TILE
    steps = (x.float().reshape(rows, 1, nk, TILE)
             * w.float().reshape(1, -1, nk, TILE)).sum(-1)  # (R, N, nk)
    out = torch.zeros((rows, w.shape[0]), dtype=torch.float32)
    for n in range(w.shape[0]):
        total = torch.zeros(rows)
        for q in range(slices[n]):
            part = torch.zeros(rows)
            for kk in range(q * nk // slices[n], (q + 1) * nk // slices[n]):
                part = part + steps[:, n, kk]
            total = total + part
        out[:, n] = total
    return out + b.float()


def _column_slices(stage_rows, piece_rows, stages):
    """Per stage, the depth slices (``tile_split``) that sum each column."""
    out = []
    for s, (_, n, depth) in enumerate(stages):
        sl = np.zeros(n, np.int64)
        for g in range(CLUSTER):
            for c0, c1, _, _ in _pieces(stage_rows, piece_rows, s, g):
                sl[c0:c1] = tile_split(c1 - c0, depth)[1]
        out.append(sl)
    return out


def _kernel_verify(t, frames, pe_rows, cross_bias, self_k, self_v, cross_k, cross_v, p, slices):
    """``decode_verify_reference`` with every matrix-vector product summed
    as the bf16 kernel sums it (``_kernel_dot``, by stage)."""
    n_layers, n_heads, _, _, dh = self_k.shape
    k, d, scale = frames.shape[0], n_heads * dh, dh ** -0.5
    bf = torch.bfloat16

    def dot(a, s, w, b):
        return _kernel_dot(a.to(bf).float(), w, b, slices[s])

    x = torch.relu(dot(frames, 0, p["pw1"], p["pb1"]))
    x = torch.relu(dot(x, 1, p["pw2"], p["pb2"]))
    x = (x + pe_rows.float()).to(bf)
    own = torch.tril(torch.ones((k, k), dtype=torch.bool))[:, None, :]
    for li in range(n_layers):
        g = 2 + 6 * li
        resid = x.float()
        qkv = dot(x, g, p["sWqkv"][li], p["sbqkv"][li])
        q = (qkv[:, :d] * scale).reshape(k, n_heads, dh)
        kn = qkv[:, d:2 * d].reshape(k, n_heads, dh)
        vn = qkv[:, 2 * d:].reshape(k, n_heads, dh)
        keys, vals = self_k[li, :, 0, :t].float(), self_v[li, :, 0, :t].float()
        s = torch.einsum("khd,hpd->khp", q.to(bf).float(), keys)
        s_cur = torch.einsum("jhd,ihd->jhi", q, kn)
        s_cur = torch.where(own, s_cur, torch.full_like(s_cur, NEG_INF))
        m = s_cur.max(-1, keepdim=True).values
        if t > 0:
            m = torch.maximum(s.max(-1, keepdim=True).values, m)
        e = torch.exp(s - m)
        e_cur = torch.where(own, torch.exp(s_cur - m), torch.zeros_like(s_cur))
        den = e.sum(-1, keepdim=True) + e_cur.sum(-1, keepdim=True)
        ctx = (torch.einsum("khp,hpd->khd", e.to(bf).float(), vals)
               + torch.einsum("jhi,ihd->jhd", e_cur, vn)) / den
        o = dot(ctx.reshape(k, d), g + 1, p["sWo"][li], p["sbo"][li])
        x32 = _layer_norm(resid + o, p["ln_g"][li, 0], p["ln_b"][li, 0])
        x = x32.to(bf)
        resid = x32
        q = (dot(x, g + 2, p["cWq"][li], p["cbq"][li]) * scale).reshape(k, n_heads, dh)
        s = torch.einsum("khd,hpd->khp", q.to(bf).float(), cross_k[li, :, 0].float())
        s = s + cross_bias.float()[:, None, :]
        e = torch.exp(s - s.max(-1, keepdim=True).values)
        ctx = torch.einsum("khp,hpd->khd", e.to(bf).float(),
                           cross_v[li, :, 0].float()) / e.sum(-1, keepdim=True)
        o = dot(ctx.reshape(k, d), g + 3, p["cWo"][li], p["cbo"][li])
        x32 = _layer_norm(resid + o, p["ln_g"][li, 1], p["ln_b"][li, 1])
        x = x32.to(bf)
        h1 = torch.relu(dot(x, g + 4, p["W1"][li], p["B1"][li]))
        h2 = dot(h1, g + 5, p["W2"][li], p["B2"][li])
        x32 = _layer_norm(x32 + h2, p["ln_g"][li, 2], p["ln_b"][li, 2])
        x = x32.to(bf)
    return dot(x, 2 + 6 * n_layers, p["head_w"], p["head_b"])


@pytest.mark.parametrize("k,t", [(2, 0), (4, 37), (8, 90)])
def test_bf16_kernel_sums_match_reference(k, t):
    """At d_model 64 (2 heads), d_ffn 512, 80 mels, 2 layers, bf16: the
    verify pass with the kernel's tensor-core summation order lands within
    the bf16 tolerance of ``decode_verify_reference``."""
    m, packed = _small_packed()
    n_pos, tp, L, H = 100, 48, m.decoder_n_layers, m.decoder_n_head
    dh = m.d_model // H
    stage_rows, piece_rows, _, stages = _plan(m, k, 2, n_pos, tp)
    assert {int(s.max()) for s in _column_slices(stage_rows, piece_rows, stages)} >= {4, 5, 16}
    rng = np.random.default_rng(k * 100 + t)
    frames = torch.from_numpy(rng.standard_normal((k, m.n_mels), np.float32))
    pe_rows = torch.from_numpy(0.5 * rng.standard_normal((k, m.d_model)).astype(np.float32))
    bias = torch.from_numpy(np.where(np.arange(tp) < 31, 0.0, NEG_INF).astype(np.float32))[None]
    sk, sv, ck, cv = [torch.from_numpy(3 * rng.standard_normal((L, H, 1, n, dh)).astype(
        np.float32)).to(torch.bfloat16) for n in (n_pos + k, n_pos + k, tp, tp)]
    y_ref, _, _ = decode_verify_reference(t, frames, pe_rows, bias, sk, sv, ck, cv, packed)
    with torch.no_grad():
        y = _kernel_verify(t, frames, pe_rows, bias, sk, sv, ck, cv, packed,
                           _column_slices(stage_rows, piece_rows, stages))
    err = float((y - y_ref).abs().max())
    assert err <= TOL_BF16 * max(1.0, float(y_ref.abs().max())), err
    assert err > 0  # the model does sum in another order


# --------------------------------------------- the transposed butterfly, plainly

def _warp_sum(v):
    """warp_sum over 32 lanes (float32): v += shfl_xor(v, o), o = 16 .. 1."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[lanes ^ o]).astype(np.float32)
    return v


def _transposed_sum(v):
    """transposed_sum of the verify kernel over (32 lanes, NV values): the
    lane's sum and the index of its value."""
    lanes, nv = np.arange(32), v.shape[1]
    v, at, m = v.copy(), np.zeros(32, np.int64), 16
    while nv > 1:
        upper = (lanes & m) != 0
        half = nv // 2
        keep = np.where(upper[:, None], v[:, half:nv], v[:, :half])
        give = np.where(upper[:, None], v[:, :half], v[:, half:nv])
        v[:, :half] = (keep + give[lanes ^ m]).astype(np.float32)
        at += np.where(upper, half, 0)
        nv, m = half, m // 2
    s = v[:, 0]
    while m > 0:
        s = (s + s[lanes ^ m]).astype(np.float32)
        m //= 2
    return s, at


@pytest.mark.parametrize("rows", [2, 3, 4, 5, 8])
def test_transposed_butterfly_has_warp_sum_bits(rows):
    """Two columns' rows (padded to a power of two) summed at once: every
    lane's sum is bit-equal to warp_sum of its (column, row); every value is
    held by 32 / NV lanes, the lowest of them the one that writes it."""
    rp = 1 << (rows - 1).bit_length()
    nv = 2 * rp
    rng = np.random.default_rng(rows)
    v = (rng.standard_normal((32, nv)) * np.exp(rng.uniform(-8, 8, (32, nv)))).astype(np.float32)
    v[:, rows:rp] = 0
    v[:, rp + rows:] = 0
    s, at = _transposed_sum(v)
    want = np.stack([_warp_sum(v[:, i]) for i in range(nv)], 1)  # every lane alike
    assert np.array_equal(s.view(np.int32), want[np.arange(32), at].view(np.int32))
    writers = np.arange(32)[(np.arange(32) & (32 // nv - 1)) == 0]
    assert sorted(at[writers]) == list(range(nv))
