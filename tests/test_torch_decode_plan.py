"""What the decode-step kernel is handed besides pointers, on the CPU.

The persistent kernel (``ops/csrc/decode_step.cu``) only checks what the
wrapper computes for it in Python (``ops/decode_step.py``): the output
columns each block of a 16-block cluster owns in every matrix-vector stage,
cut into weight pieces, where each piece lies in the block's shared-memory
ring and when it is copied, the rows a cluster decodes, the attention
chunks, and the shared-memory layout.  These tests hold those plans to what
the kernel assumes, at ``Config()`` and ``configs/paper.yaml`` widths, and
hold a plain-PyTorch model of the kernel's chunked softmax (chunk maxima,
then the chunks' sums against the global max, added in chunk order)
against ``decode_step_reference``.

Tolerance of the chunked model, as max|model - reference| <= tol *
max(1, max|reference|): fp32 1e-5 and bf16 2e-2, as the kernel's own
tests: both round each probability to bf16 at the same point, against the
global max, and differ only in the order of fp32 sums.
"""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from transformertts_tpu_torch.config import Config, load_config, tiny_config
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.models.masks import NEG_INF
from transformertts_tpu_torch.ops import decode_step as decode_step_mod
from transformertts_tpu_torch.ops.decode_step import (
    CLUSTER,
    MAX_PIECES,
    PIECE_BYTES,
    SMEM_BUFFERS,
    SMEM_LIMIT,
    DecodeStep,
    _layer_norm,
    attn_chunks,
    bias_table,
    card_plan,
    chunks_max,
    decode_plan,
    decode_step_reference,
    gemv_stages,
    pack_decode_weights,
    ring_placement,
    rows_per_cluster,
    self_chunks,
    stage_biases,
)

WIDTHS = {
    "config": Config().model,
    "paper": load_config(Path(__file__).resolve().parents[1] / "configs" / "paper.yaml").model,
}


def _plan(widths, rows, itemsize, n_pos=1500, tp=192, cluster=CLUSTER):
    m = WIDTHS[widths]
    d_out = m.n_mels * m.reduction_factor + m.reduction_factor
    args = (m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels, d_out)
    plan = decode_plan(*args, rows, m.decoder_n_head, n_pos, tp, itemsize, cluster)
    return (*plan, gemv_stages(*args))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,cluster", [(1, 16), (2, 16), (1, 12), (1, 8)])
@pytest.mark.parametrize("widths", ["config", "paper"])
def test_plan_owns_every_column_once(widths, rows, cluster, itemsize):
    """Every output column of every stage belongs to one piece of one block
    of the cluster (of 16 blocks, or 12 or 8 where the card holds too few
    clusters of 16); a block's pieces of a stage are consecutive and no
    larger than PIECE_BYTES, and its biases follow stage after stage."""
    stage_rows, piece_rows, layout, stages = _plan(widths, rows, itemsize, cluster=cluster)
    assert stage_rows.shape == (len(stages), cluster, 4)
    assert layout["smem_bytes"] <= SMEM_LIMIT
    for s, (name, n, k) in enumerate(stages):
        owned = np.zeros(n, np.int64)
        for g in range(cluster):
            first, end, bias_at, _ = stage_rows[s, g]
            expect_bias = sum(int(piece_rows[e - 1, g, 1] - piece_rows[f, g, 0])
                              for f, e, _, _ in stage_rows[:s, g] if e > f)
            assert bias_at == expect_bias
            for c0, c1, _, _ in piece_rows[first:end, g]:
                assert 0 <= c0 < c1 <= n, name
                assert (c1 - c0) * k * itemsize <= max(PIECE_BYTES, k * itemsize)
                owned[c0:c1] += 1
            if end > first:
                cols = piece_rows[first:end, g, :2]
                assert (cols[1:, 0] == cols[:-1, 1]).all()
        assert (owned == 1).all(), f"{name}: columns owned {owned.min()}..{owned.max()} times"


def _fits(widths, rows, itemsize):
    try:
        _plan(widths, rows, itemsize)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("b", range(1, 9))
@pytest.mark.parametrize("widths", ["config", "paper"])
def test_ring_and_buffers_fit(widths, b):
    """For B = 1..8 in bf16 and fp32 the wrapper finds rows per cluster
    whose buffers and ring fit the 227 KB a block may have (on a card that
    holds 7 clusters of 16 at once; every R at Config() widths); every
    piece lies inside the ring, "issue after" never decreases, and a piece
    is copied only after every earlier piece on its bytes has been used."""
    for itemsize in (2, 4):
        if widths == "config":
            assert all(_fits(widths, r, itemsize) for r in range(1, 9))
        rows = rows_per_cluster(b, lambda r: 7 if _fits(widths, r, itemsize) else 0)
        assert b // rows <= 7
        stage_rows, piece_rows, layout, stages = _plan(widths, rows, itemsize)
        assert layout["smem_bytes"] <= SMEM_LIMIT
        offsets = [layout[k] for k in SMEM_BUFFERS]
        assert offsets == sorted(offsets) and all(o % 16 == 0 for o in offsets)
        assert piece_rows.shape[0] <= MAX_PIECES
        for g in range(CLUSTER):
            # piece 0 is stage 0's first, at ring offset 0, copied at once (the
            # kernel issues it from its arguments before the plan lands)
            assert stage_rows[0, g, 0] == 0 and tuple(piece_rows[0, g, 2:]) == (0, -1)
            spans, last_after = [], -1
            n_real = int(stage_rows[-1, g, 1])
            assert (piece_rows[n_real:, g, 3] == 1 << 30).all()  # padding, never copied
            for i in range(n_real):
                c0, c1, off, after = piece_rows[i, g]
                s = next(s for s in range(len(stages)) if stage_rows[s, g, 0] <= i
                         < stage_rows[s, g, 1])
                nbytes = (c1 - c0) * stages[s][2] * itemsize
                assert off % 16 == 0 and off + nbytes <= layout["ring_bytes"]
                assert last_after <= after < i
                last_after = after
                for i2, a, e in spans:
                    if a < off + nbytes and off < e:  # shares bytes with an earlier piece
                        assert i2 <= after, (g, i, i2, after)
                spans.append((i, off, off + nbytes))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("cluster", [16, 12, 8])
def test_plan_takes_large_tp_widths(cluster, itemsize):
    """``configs/large_tp.yaml``'s decoder (d_model 1,024, 16 heads, d_ffn
    4,096, 6 layers), one row a cluster: fp32 needs 682 weight pieces a
    block in clusters of 16 and 1,364 in clusters of 8, which the cap of 512
    pieces refused (the fp32 decode of ``cli synthesize`` at these widths
    raised on the GPU); the table fits the block's shared memory."""
    stage_rows, piece_rows, layout = decode_plan(6, 1024, 4096, 80, 81, 1, 16, 400, 64,
                                                 itemsize, cluster)
    assert layout["smem_bytes"] <= SMEM_LIMIT and piece_rows.shape[0] <= MAX_PIECES
    if itemsize == 4:
        assert piece_rows.shape[0] == {16: 682, 12: 919, 8: 1364}[cluster]


def test_ring_placement_refills():
    """A ring that holds two of three pieces: the third waits for the first."""
    assert ring_placement([100, 100, 100], 208) == [(0, -1), (100, -1), (0, 0)]
    with pytest.raises(ValueError, match="exceeds"):
        ring_placement([300], 208)


def test_rows_per_cluster():
    """The fewest rows a cluster whose clusters the card holds at once."""
    assert rows_per_cluster(8, lambda r: 8) == 1
    assert rows_per_cluster(8, lambda r: 7) == 2
    assert rows_per_cluster(6, lambda r: 4) == 2
    assert rows_per_cluster(7, lambda r: 4) == 7
    assert rows_per_cluster(8, lambda r: 7 if r <= 2 else 0) == 2
    with pytest.raises(ValueError, match="no rows per cluster"):
        rows_per_cluster(3, lambda r: 0)


@pytest.mark.parametrize("rows,n_heads,cluster", [(1, 4, 16), (8, 4, 16), (1, 8, 16), (8, 8, 16),
                                                  (3, 2, 16), (1, 4, 12), (1, 8, 8)])
def test_key_chunks_cover_once(rows, n_heads, cluster):
    """The chunks of [0, n) cover every key once, for the self keys at every
    t of a 1,500-position cache (t = 0 has none) and the encoder keys; a
    cluster's blocks have at most one (row, head, chunk) item each when
    there are several chunks, and the combine's buffers hold every chunk."""
    for n in list(range(0, 70)) + [199, 200, 256, 257, 700, 1498, 1499, 192, 64]:
        length, nc = attn_chunks(n, rows, n_heads, cluster)
        if n == 0:
            assert (length, nc) == (0, 0)
            continue
        covered = np.zeros(n, np.int64)
        for c in range(nc):
            lo, hi = c * length, min((c + 1) * length, n)
            assert lo < hi, (n, c)
            covered[lo:hi] += 1
        assert (covered == 1).all(), n
        assert nc <= chunks_max(rows, n_heads, cluster)
        assert nc == 1 or rows * n_heads * nc <= cluster


def test_prepared_step_refuses_cpu_tensors():
    """The prepared step is the GPU path only: CPU caches are refused."""
    m = tiny_config().model
    model = TransformerTTS(m, dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    packed = pack_decode_weights(model, torch.float32)
    dh = m.d_model // m.decoder_n_head
    caches = [torch.zeros((m.decoder_n_layers, m.decoder_n_head, 1, n, dh)) for n in (8, 8, 4, 4)]
    with pytest.raises(ValueError, match="is on cpu"):
        DecodeStep(*caches, packed)


# --------------------------------------------------- plans made once per shape

def _assert_same_plan(got, want):
    assert [np.array_equal(a, b) for a, b in zip(got[:2], want[:2])] == [True, True]
    assert got[2] == want[2]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,cluster", [(1, 16), (2, 16), (1, 12), (1, 8)])
@pytest.mark.parametrize("widths", ["config", "paper"])
def test_memoised_plan_equals_a_fresh_one(widths, rows, cluster, itemsize):
    """``decode_plan`` is memoised: a second call, and a call with another
    encoder length under the cache's (the plan reads them as ``max(n_pos,
    tp)``), give the plan computed afresh, arrays and layout; the shared
    arrays are read-only and each caller gets its own layout."""
    m = WIDTHS[widths]
    d_out = m.n_mels * m.reduction_factor + m.reduction_factor
    args = (m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels, d_out, rows,
            m.decoder_n_head)
    fresh = decode_step_mod._plan_of.__wrapped__(*args, 576, itemsize, cluster)
    first = decode_plan(*args, 576, 192, itemsize, cluster)
    for tp in (192, 64, 576):
        got = decode_plan(*args, 576, tp, itemsize, cluster)
        _assert_same_plan(got, fresh)
        assert got[0] is first[0] and got[1] is first[1] and got[2] is not first[2]
        assert not got[0].flags.writeable and not got[1].flags.writeable
    longer = decode_plan(*args, 576, 600, itemsize, cluster)  # more keys: another plan
    assert longer[2]["scores"] == fresh[2]["scores"] and longer[2] != fresh[2]


class _FakeCard:
    """The decode library's occupancy query on a card that holds 7 clusters
    of 16 blocks, 11 of 12 and 16 of 8 (none where the block's shared
    memory is over the limit); counts the queries."""

    def __init__(self):
        self.queries = 0

    def tts_decode_step_max_clusters(self, is_bf16, rows, smem, cluster):
        self.queries += 1
        return {16: 7, 12: 11, 8: 16}[cluster] if smem <= SMEM_LIMIT else 0


@pytest.fixture
def fake_card(monkeypatch):
    card = _FakeCard()
    monkeypatch.setattr(decode_step_mod, "_lib", lambda name="decode_step": card)
    decode_step_mod._card_plan_of.cache_clear()
    yield card
    decode_step_mod._card_plan_of.cache_clear()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 6, 8])
@pytest.mark.parametrize("widths", ["config", "paper"])
def test_memoised_card_plan_equals_a_fresh_one(fake_card, widths, b, dtype):
    """``card_plan`` is memoised on its integers, the dtype and the device:
    a second call and another encoder length under the cache's ask the card
    nothing more and give the fresh computation's clusters, rows and plan
    (B <= 7 in clusters of 16 one row each, B = 8 in clusters of 12 here)."""
    m = WIDTHS[widths]
    d_out = m.n_mels * m.reduction_factor + m.reduction_factor
    args = (m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels, d_out, b, m.decoder_n_head)
    fresh = decode_step_mod._card_plan_of.__wrapped__(*args, 576, dtype,
                                                      decode_step_mod._device_index())
    assert fresh[:2] == ((16, 1) if b <= 7 else (12, 1))
    asked = fake_card.queries
    for tp in (96, 192, 576):
        got = card_plan(*args, 576, tp, dtype)
        assert got[:2] == fresh[:2]
        _assert_same_plan(got[2], fresh[2])
    assert fake_card.queries - asked <= 2  # the first call's probes only
    asked = fake_card.queries
    card_plan(*args, 576, 64, dtype)
    assert fake_card.queries == asked


def test_self_chunks_are_attn_chunks():
    """The memoised self-attention chunks of every position."""
    got = self_chunks(300, 2, 4, 16)
    assert got is self_chunks(300, 2, 4, 16)
    assert got == tuple(attn_chunks(t, 2, 4, 16) for t in range(300))


def _bias_table_per_slice(biases, stage_rows, piece_rows, n_bias):
    """The bias table as it was built before, one host copy a slice."""
    cluster = stage_rows.shape[1]
    table = torch.zeros((cluster, n_bias), dtype=torch.float32)
    for g in range(cluster):
        for s, bias in enumerate(biases):
            first, end, at, _ = (int(v) for v in stage_rows[s, g])
            if end > first:
                c0, c1 = int(piece_rows[first, g, 0]), int(piece_rows[end - 1, g, 1])
                table[g, at:at + c1 - c0] = bias[c0:c1].float().cpu()
    return table


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,cluster", [(1, 16), (2, 16), (1, 12)])
def test_bias_table_from_one_copy_equals_the_per_slice_one(rows, cluster, dtype):
    """The bias table filled from one host copy of every stage's bias is
    the per-slice table, bit for bit, at ``Config()``-like widths."""
    m = dataclasses.replace(tiny_config().model, d_model=64, decoder_n_head=2, decoder_d_ffn=128)
    model = TransformerTTS(m, dtype=dtype, device="cpu",
                           generator=torch.Generator().manual_seed(rows * 10 + cluster))
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(generator=torch.Generator().manual_seed(p.numel()))
    packed = pack_decode_weights(model, dtype)
    d_out = m.n_mels * m.reduction_factor + m.reduction_factor
    stage_rows, piece_rows, layout = decode_plan(
        m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels, d_out, rows, m.decoder_n_head,
        40, 16, packed["pw1"].element_size(), cluster)
    biases = stage_biases(packed, m.decoder_n_layers)
    got = bias_table(biases, stage_rows, piece_rows, layout["n_bias"])
    want = _bias_table_per_slice(biases, stage_rows, piece_rows, layout["n_bias"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want) and bool((got != 0).any())


# ------------------------------------------------- the chunked softmax, plainly

def _chunked_attention(q, k, v, bias, cur, length, nc, dtype, col=None):
    """What the kernel's attention computes for one layer, in its two
    stages: per (row, head) and chunk the scores and their max m_c; then,
    against the global max m = max(m_c, s_cur), per chunk l_c = sum e,
    sum T(e) v and (with col) sum e * key for e = exp(s - m), added in
    chunk order; ``cur`` = (s_cur, v_cur) folds the current position in
    closed form.  q (B, H, dh) fp32, k / v (H, B, n, dh), bias (B, n)."""
    s = torch.einsum("bhd,hbpd->bhp", q.to(dtype).float(), k.float())
    if bias is not None:
        s = s + bias[:, None, :]
    chunks = [slice(c * length, (c + 1) * length) for c in range(nc)]
    ms = [s[..., c].max(-1, keepdim=True).values for c in chunks]
    ms += [cur[0]] if cur is not None else []
    m = torch.stack(ms).max(0).values
    den = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    pos = torch.zeros_like(m)
    for c in chunks:  # chunk order
        e = torch.exp(s[..., c] - m)
        den = den + e.sum(-1, keepdim=True)
        acc = acc + torch.einsum("bhp,hbpd->bhd", e.to(dtype).float(), v[:, :, c].float())
        if col is not None:
            pos = pos + (e * col[c]).sum(-1, keepdim=True)
    if cur is not None:
        e_cur = torch.exp(cur[0] - m)
        den = den + e_cur
        acc = acc + e_cur * cur[1]
    return acc / den, pos / den


def _chunked_step(t, frame, pe_row, cross_bias, self_k, cross_k, self_v, cross_v, packed, n_blocks):
    """``decode_step_reference`` with the kernel's chunked attention (chunks
    of at least 16 keys, so that short caches split too)."""
    n_layers, n_heads, b, n_pos, dh = self_k.shape
    d = n_heads * dh
    dtype = packed["pw1"].dtype
    scale = dh ** -0.5
    p = packed

    def dot(a, w):
        return a.to(dtype).float() @ w.float().t()

    x = torch.relu(dot(frame, p["pw1"]) + p["pb1"].float())
    x = torch.relu(dot(x, p["pw2"]) + p["pb2"].float())
    x = (x + pe_row.float()).to(dtype)
    tp = cross_k.shape[3]
    col = torch.arange(tp, dtype=torch.float32)
    s_len, s_nc = attn_chunks(t, b, n_heads, n_blocks, min_chunk=16)
    c_len, c_nc = attn_chunks(tp, b, n_heads, n_blocks, min_chunk=16)
    assert max(s_nc, c_nc) > 1 or t == 0
    pos = None
    for li in range(n_layers):
        resid = x.float()
        qkv = dot(x, p["sWqkv"][li]) + p["sbqkv"][li].float()
        q = (qkv[:, :d] * scale).reshape(b, n_heads, dh)
        kn = qkv[:, d:2 * d].reshape(b, n_heads, dh)
        vn = qkv[:, 2 * d:].reshape(b, n_heads, dh)
        s_cur = (q * kn).sum(-1, keepdim=True)
        ctx, _ = _chunked_attention(q, self_k[li, :, :, :t], self_v[li, :, :, :t], None,
                                    (s_cur, vn), s_len, s_nc, dtype)
        o = dot(ctx.reshape(b, d), p["sWo"][li]) + p["sbo"][li].float()
        x32 = _layer_norm(resid + o, p["ln_g"][li, 0], p["ln_b"][li, 0])
        x = x32.to(dtype)
        resid = x32
        q = ((dot(x, p["cWq"][li]) + p["cbq"][li].float()) * scale).reshape(b, n_heads, dh)
        ctx, pos_h = _chunked_attention(q, cross_k[li], cross_v[li], cross_bias.float(), None,
                                        c_len, c_nc, dtype, col)
        pos = pos_h.sum(1) / n_heads
        o = dot(ctx.reshape(b, d), p["cWo"][li]) + p["cbo"][li].float()
        x32 = _layer_norm(resid + o, p["ln_g"][li, 1], p["ln_b"][li, 1])
        x = x32.to(dtype)
        h1 = torch.relu(dot(x, p["W1"][li]) + p["B1"][li].float())
        h2 = dot(h1, p["W2"][li]) + p["B2"][li].float()
        x32 = _layer_norm(x32 + h2, p["ln_g"][li, 2], p["ln_b"][li, 2])
        x = x32.to(dtype)
    y = dot(x, p["head_w"]) + p["head_b"].float()
    return y, pos


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t", [(1, 0), (1, 1), (1, 150), (3, 199), (3, 77)])
def test_chunked_softmax_matches_reference(b, t, dtype, tol):
    """At 12 blocks the attention splits into up to 12 / (B H) chunks (6 at
    B = 1 here, 2 at B = 3): the chunked model agrees with the reference."""
    m = dataclasses.replace(tiny_config().model, d_model=64, decoder_n_head=2, decoder_d_ffn=128)
    gen = torch.Generator().manual_seed(b * 100 + t)
    model = TransformerTTS(m, dtype=dtype, device="cpu", generator=gen)
    packed = pack_decode_weights(model, dtype)
    n_pos, tp, dh, L = 200, 70, m.d_model // m.decoder_n_head, m.decoder_n_layers
    rng = np.random.default_rng(t)
    frame = torch.from_numpy(rng.standard_normal((b, m.n_mels), np.float32))
    pe_row = torch.from_numpy(0.5 * rng.standard_normal((1, m.d_model)).astype(np.float32))
    lens = np.array([tp, 41, 13][:b])
    bias = torch.from_numpy(np.where(np.arange(tp)[None, :] < lens[:, None], 0.0,
                                     NEG_INF).astype(np.float32))
    sk, sv, ck, cv = [torch.from_numpy(3 * rng.standard_normal(
        (L, m.decoder_n_head, b, n, dh)).astype(np.float32)).to(dtype)
        for n in (n_pos, n_pos, tp, tp)]
    assert attn_chunks(150, 1, 2, 12, min_chunk=16)[1] == 6
    y_ref, _, _, pos_ref = decode_step_reference(t, frame, pe_row, bias, sk, sv, ck, cv, packed,
                                                 with_attn_pos=True)
    with torch.no_grad():
        y, pos = _chunked_step(t, frame, pe_row, bias, sk, ck, sv, cv, packed, n_blocks=12)
    for name, got, ref in (("y", y, y_ref), ("pos", pos, pos_ref)):
        err = float((got - ref).abs().max())
        assert err <= tol * max(1.0, float(ref.abs().max())), (name, err)
