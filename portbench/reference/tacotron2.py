"""Plain Tacotron 2 in float32 (Shen et al., arXiv:1712.05884, as NVIDIA's
``model.py`` builds it, github.com/NVIDIA/tacotron2): no kernel, no cache
of its own, TF32 off.

- Encoder: embedding, convolutions (k 5) + BatchNorm + ReLU, a BiLSTM;
  each row runs alone at its own length, so nothing pads it.
- Decoder, teacher-forced: at step t the input is the served frame t - 1
  (a zero go frame at 0) through the bias-free ReLU prenet with dropout
  0.5 on (NVIDIA keeps it on at inference), the attention LSTM cell over
  [prenet; context], location-sensitive additive attention (a 2-channel
  convolution of the previous weights and their running sum, no bias,
  then a dense layer; a query layer; the processed memory; ``v . tanh``;
  softmax), the decoder LSTM cell over [h1; context], the projection and
  the gate over [h2; context].
- Postnet: convolutions + BatchNorm with tanh but the last, residual.

``PlainT2(m, w, q)`` holds the model settings ``m`` (a configuration
file's ``model`` object), the weights ``w`` (name -> tensor, as
``tacotron2_weights.py`` makes them) and ``q``, the rounding applied to
every operand of a product (the identity, or ``fp8`` for the control).

Departures from NVIDIA's ``model.py``, each with its reason:

- The prenet's dropout masks are the program's counter hash (a copy in
  ``masks.py``: salt ``2 t + layer``, counter ``row * prenet_dim +
  column``, seed ``training.seed ^ 0x5EED``), fed the row index each
  request had in its served batch, not ``torch``'s RNG: a served frame can
  only be checked against the masks it was served with.
- The decoder steps of the checked requests run side by side, each over
  its own encoder positions (the others masked out of the softmax): per
  row the same sums as one request alone, since a masked position has
  weight 0 and the location convolution sees 0 there as it would see its
  zero padding.  NVIDIA's inference runs B 1 unmasked: the same per row.
- A row's decode stops at the served length (teacher forcing reads the
  served prefix); NVIDIA's stops at ``sigmoid(gate) > 0.5``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import masks
from portbench.reference.model import ident

PRENET_SALT_SEED = 0x5EED


class PlainT2:
    def __init__(self, m: dict, w: dict, q=ident):
        self.m, self.w, self.q = m, w, q

    def lin(self, x, name, bias=False):
        q = self.q
        y = q(x) @ q(self.w[f"{name}.weight"]).t()
        return y + self.w[f"{name}.bias"] if bias else y

    def conv_bn(self, x, name):
        """(B, T, C) -> (B, T, C') same-padded convolution + eval BatchNorm."""
        q, w = self.q, self.w
        wt = w[f"{name}.Conv_0.weight"]
        y = F.conv1d(q(x).transpose(1, 2), q(wt), padding=(wt.shape[2] - 1) // 2)
        y = y.transpose(1, 2) + w[f"{name}.Conv_0.bias"]
        bn = f"{name}.BatchNorm_0"
        return ((y - w[f"{bn}.running_mean"]) * torch.rsqrt(w[f"{bn}.running_var"] + 1e-5)
                * w[f"{bn}.weight"] + w[f"{bn}.bias"])

    def cell(self, x, h, c, name, suffix=""):
        """One LSTM cell step, gates i, f, g, o (``torch.nn.LSTMCell``)."""
        q, w = self.q, self.w
        gates = (q(x) @ q(w[f"{name}.weight_ih{suffix}"]).t() + w[f"{name}.bias_ih{suffix}"]
                 + q(h) @ q(w[f"{name}.weight_hh{suffix}"]).t() + w[f"{name}.bias_hh{suffix}"])
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    # ---------------------------------------------------------------- model

    def encode(self, ids: torch.Tensor) -> torch.Tensor:
        """One row's ids (n,) -> its memory (n, E), unpadded."""
        m, w = self.m, self.w
        x = w["emb.weight"][ids][None]
        for i in range(m["encoder_n_convolutions"]):
            x = torch.relu(self.conv_bn(x, f"encoder.ConvBN_{i}"))
        x = x[0]
        hid = m["encoder_embedding_dim"] // 2
        outs = []
        for suffix, order in (("_l0", range(len(ids))), ("_l0_reverse", reversed(range(len(ids))))):
            h = c = torch.zeros(hid, device=x.device)
            seq = [None] * len(ids)
            for t in order:
                h, c = self.cell(x[t], h, c, "encoder.lstm", suffix)
                seq[t] = h
            outs.append(torch.stack(seq))
        return torch.cat(outs, -1)

    def decode(self, memories: list, frames: torch.Tensor, rows: list, seed: int, rate: float):
        """Teacher-forced decoder over the rows' memories (each (n_i, E)) and
        served frames (R, T, n_mels): the frames (R, T, n_mels) and gate
        logits (R, T) at every position.  ``rows``: each request's row index
        in its served batch, for the prenet masks."""
        m, w, q = self.m, self.w, self.q
        dev = frames.device
        n_rows, n_t = frames.shape[:2]
        tp = max(len(mem) for mem in memories)
        e_dim = m["encoder_embedding_dim"]
        memory = torch.zeros((n_rows, tp, e_dim), device=dev)
        for i, mem in enumerate(memories):
            memory[i, : len(mem)] = mem
        lens = torch.tensor([len(mem) for mem in memories], device=dev)
        valid = torch.arange(tp, device=dev)[None, :] < lens[:, None]
        att = "decoder.attention_layer"
        pm = self.lin(memory, f"{att}.memory_layer.Dense_0")
        p_dim, k = m["prenet_dim"], m["attention_location_kernel_size"]
        row_t = torch.tensor(rows, dtype=torch.int64, device=dev)[:, None]
        col = torch.arange(p_dim, dtype=torch.int64, device=dev)[None, :]
        z = lambda n: torch.zeros((n_rows, n), device=dev)  # noqa: E731
        h1, c1 = z(m["attention_rnn_dim"]), z(m["attention_rnn_dim"])
        h2, c2 = z(m["decoder_rnn_dim"]), z(m["decoder_rnn_dim"])
        alpha, alpha_cum, ctx = z(tp), z(tp), z(e_dim)
        mels, gates = [], []
        for t in range(n_t):
            x = frames[:, t - 1] if t else torch.zeros_like(frames[:, 0])
            for layer in (0, 1):
                x = torch.relu(self.lin(x, f"decoder.prenet.LinearNorm_{layer}.Dense_0"))
                if rate > 0.0:
                    keep = masks.keep_from_index(row_t * p_dim + col, 2 * t + layer, seed, rate)
                    x = torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
            h1, c1 = self.cell(torch.cat([x, ctx], -1), h1, c1, "decoder.attention_rnn")
            loc = F.conv1d(q(torch.stack([alpha, alpha_cum], 1)), q(w[f"{att}.location_conv"]),
                           padding=(k - 1) // 2)  # (R, n_filters, Tp)
            f = self.lin(loc.transpose(1, 2), f"{att}.location_dense.Dense_0")
            query = self.lin(h1, f"{att}.query_layer.Dense_0")[:, None, :]
            e = self.lin(torch.tanh(query + f + pm), f"{att}.v.Dense_0")[..., 0]
            alpha = torch.softmax(e.masked_fill(~valid, float("-inf")), dim=1)
            ctx = (q(alpha)[:, None, :] @ q(memory))[:, 0]
            alpha_cum = alpha_cum + alpha
            h2, c2 = self.cell(torch.cat([h1, ctx], -1), h2, c2, "decoder.decoder_rnn")
            hc = torch.cat([h2, ctx], -1)
            mels.append(self.lin(hc, "decoder.linear_projection.Dense_0", bias=True))
            gates.append(self.lin(hc, "decoder.gate_layer.Dense_0", bias=True)[:, 0])
        return torch.stack(mels, 1), torch.stack(gates, 1)

    def postnet(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) -> postnet(mel) + mel."""
        n, x = self.m["postnet_n_layers"], mel
        for i in range(n):
            x = self.conv_bn(x, f"postnet.ConvBN_{i}")
            if i < n - 1:
                x = torch.tanh(x)
        return x + mel

    def served(self, ids: list, frames: torch.Tensor, rows: list, seed: int, rate: float):
        """What the served requests should have got, read against the frames
        they were served: for each request's ids (a list of (n_i,) tensors),
        their (R, T, n_mels) frames and row indices, the reference's frames
        and gate logits at every position given the served prefix, and the
        postnet output over the served frames."""
        memories = [self.encode(i) for i in ids]
        mel, gate = self.decode(memories, frames, rows, seed, rate)
        return mel, gate, self.postnet(frames)


def prenet_seed(training_seed: int) -> int:
    """The seed of the served prenet masks (the program's ``training.seed ^
    0x5EED``)."""
    return int(training_seed) ^ PRENET_SALT_SEED
