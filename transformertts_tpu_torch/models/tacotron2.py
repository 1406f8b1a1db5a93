"""Tacotron 2 (Shen et al., "Natural TTS Synthesis by Conditioning WaveNet on
Mel Spectrogram Predictions", arXiv:1712.05884) at NVIDIA's published
recipe (github.com/NVIDIA/tacotron2, ``hparams.py`` and ``model.py``).

- Encoder: an embedding, ``encoder_n_convolutions`` x [Conv1d (k
  ``encoder_kernel_size``) -> BatchNorm -> ReLU] and a BiLSTM of
  ``encoder_embedding_dim / 2`` each way over each row's own length (as
  ``pack_padded_sequence``); padded positions are zeroed before every
  convolution, so a row of a padded batch encodes as it does alone.
- Decoder step t, from a zero go frame and zero states: a prenet of two
  bias-free ReLU layers of ``prenet_dim``, each followed by dropout that
  stays on at inference (paper section 2.3; here the counter-hash masks of
  ``ops.decode_step.prenet_keep``, rate ``runtime.infer_prenet_dropout``);
  the attention LSTM cell over [prenet; context]; location-sensitive
  additive attention, ``e_j = v . tanh(W_q h1 + W_ld conv([a; a_cum])_j +
  W_mem memory_j)`` masked past each row's length, its softmax ``a``, the
  context ``sum_j a_j memory_j`` and ``a_cum += a``; the decoder LSTM cell
  over [h1; context]; the frame ``W_proj [h2; context] + b`` and the stop
  logit ``w_gate . [h2; context] + b``.
- Postnet: the port's ``PostNet`` at ``postnet_embedding_dim``, added to
  the frames.

Parameters are fp32; ``dtype`` is the compute type: products take
``dtype`` operands (a dense layer rounds its result to ``dtype`` before the
bias, as ``modules.Linear``), the LSTM cell states, the attention weights
and their running sum stay fp32.  The encoder's BiLSTM runs on the fp32
parameters (``torch.nn.LSTM``, cuDNN on the GPU) and hands ``dtype`` on.

Training is not ported: ``forward`` is a teacher-forced pass for
evaluation (dropout off but the prenet's, which takes its masks from the
caller) and the train step refuses the architecture.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from transformertts_tpu_torch.config import ModelConfig
from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.models.initializers import xavier_normal_
from transformertts_tpu_torch.models.masks import lengths_to_valid_mask
from transformertts_tpu_torch.models.modules import ConvBN, Embed, LinearNorm, PostNet


def _uniform_(t: torch.Tensor, bound: float, generator) -> None:
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)


def _lstm_cell(cell: nn.LSTMCell, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """One LSTM cell step (gates i, f, g, o as ``torch.nn.LSTMCell``): the
    products in ``dtype`` over [x; h], the gates and the cell in fp32."""
    gates = (torch.cat([x, h], -1).to(dtype)
             @ torch.cat([cell.weight_ih, cell.weight_hh], 1).to(dtype).t()).float()
    gates = gates + (cell.bias_ih + cell.bias_hh)
    i, f, g, o = gates.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class Encoder(nn.Module):
    def __init__(self, c: ModelConfig, dtype, device):
        super().__init__()
        self.n = c.encoder_n_convolutions
        for i in range(self.n):
            setattr(self, f"ConvBN_{i}", ConvBN(c.encoder_embedding_dim, c.encoder_embedding_dim,
                                                 c.encoder_kernel_size, "relu", dtype, device))
        with torch.device("meta"):
            self.lstm = nn.LSTM(c.encoder_embedding_dim, c.encoder_embedding_dim // 2, 1,
                                batch_first=True, bidirectional=True)
        if device.type != "meta":
            self.lstm.to_empty(device=device)
        self.dtype = dtype

    def reset_parameters(self, generator) -> None:
        bound = self.lstm.hidden_size ** -0.5
        for p in self.lstm.parameters():
            _uniform_(p, bound, generator)

    def forward(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """(B, Tp, E) embedded ids and (B,) lengths -> (B, Tp, E) memory in
        ``dtype``, zero past each row's length."""
        keep = lengths_to_valid_mask(lens, x.shape[1])[..., None]
        x = x.to(self.dtype) * keep
        for i in range(self.n):
            x = torch.relu(getattr(self, f"ConvBN_{i}")(x)) * keep
        packed = pack_padded_sequence(x.float(), lens.cpu(), batch_first=True,
                                      enforce_sorted=False)
        out, _ = self.lstm(packed)
        out, _ = pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])
        return out.to(self.dtype)


class Attention(nn.Module):
    """Location-sensitive additive attention (NVIDIA ``Attention`` with its
    ``LocationLayer``); every layer bias-free."""

    def __init__(self, c: ModelConfig, dtype, device):
        super().__init__()
        a, n_f = c.attention_dim, c.attention_location_n_filters
        k = c.attention_location_kernel_size
        self.query_layer = LinearNorm(c.attention_rnn_dim, a, False, "tanh", dtype, device)
        self.memory_layer = LinearNorm(c.encoder_embedding_dim, a, False, "tanh", dtype, device)
        self.v = LinearNorm(a, 1, False, "linear", dtype, device)
        self.location_conv = nn.Parameter(torch.empty(n_f, 2, k, device=device))
        self.location_dense = LinearNorm(n_f, a, False, "tanh", dtype, device)
        self.dtype = dtype

    def reset_parameters(self, generator) -> None:
        xavier_normal_(self.location_conv, "linear", generator)

    def forward(self, h1, memory, pm, valid, alpha, alpha_cum):
        """(B, A) -> new attention weights (B, Tp) fp32 and context (B, E) fp32."""
        k = self.location_conv.shape[2]
        loc = F.conv1d(torch.stack([alpha, alpha_cum], 1).to(self.dtype),
                       self.location_conv.to(self.dtype), padding=(k - 1) // 2)
        f = self.location_dense(loc.transpose(1, 2))  # (B, Tp, A)
        e = self.v(torch.tanh(self.query_layer(h1)[:, None, :] + f + pm)).float()[..., 0]
        e = e.masked_fill(~valid, float("-inf"))
        a = torch.softmax(e, dim=1)
        return a, (a[:, None, :].to(self.dtype) @ memory).float()[:, 0]


class Decoder(nn.Module):
    def __init__(self, c: ModelConfig, dtype, device):
        super().__init__()
        self.prenet = nn.Module()
        self.prenet.LinearNorm_0 = LinearNorm(c.n_mels, c.prenet_dim, False, "linear", dtype,
                                              device)
        self.prenet.LinearNorm_1 = LinearNorm(c.prenet_dim, c.prenet_dim, False, "linear", dtype,
                                              device)
        e = c.encoder_embedding_dim
        with torch.device("meta"):
            self.attention_rnn = nn.LSTMCell(c.prenet_dim + e, c.attention_rnn_dim)
            self.decoder_rnn = nn.LSTMCell(c.attention_rnn_dim + e, c.decoder_rnn_dim)
        if device.type != "meta":
            self.attention_rnn.to_empty(device=device)
            self.decoder_rnn.to_empty(device=device)
        self.attention_layer = Attention(c, dtype, device)
        self.linear_projection = LinearNorm(c.decoder_rnn_dim + e, c.n_mels, True, "linear",
                                            dtype, device)
        self.gate_layer = LinearNorm(c.decoder_rnn_dim + e, 1, True, "sigmoid", dtype, device)

    def reset_parameters(self, generator) -> None:
        for cell in (self.attention_rnn, self.decoder_rnn):
            for p in cell.parameters():
                _uniform_(p, cell.hidden_size ** -0.5, generator)


class Tacotron2(nn.Module):
    """Parameters are fp32; ``dtype`` is the compute dtype (bf16 or fp32).
    ``device`` None means the GPU; weights are drawn on the CPU from
    ``generator`` (seed 0 when None) and then moved; ``"meta"`` builds the
    shapes only."""

    architecture = "tacotron2"

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        build = device if device.type == "meta" else torch.device("cpu")
        self.cfg, self.dtype = cfg, dtype
        c = cfg
        self.emb = Embed(c.n_phon, c.symbols_embedding_dim, device=build)
        self.encoder = Encoder(c, dtype, build)
        self.decoder = Decoder(c, dtype, build)
        self.postnet = PostNet(c.postnet_n_layers, c.n_mels, c.postnet_embedding_dim,
                               c.postnet_kernel_size, c.postnet_dropout, dtype, device=build)
        if build.type != "meta":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            for m in self.modules():
                if m is not self and hasattr(m, "reset_parameters") and not isinstance(
                        m, (nn.LSTM, nn.LSTMCell)):
                    m.reset_parameters(generator)
            self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.emb.weight.device

    # --- the pieces the decode loops share ---

    def encode(self, phoneme: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """(B, Tp) ids, (B,) lengths -> (B, Tp, E) memory in ``dtype``."""
        return self.encoder(self.emb(phoneme), lens)

    def process_memory(self, memory: torch.Tensor) -> torch.Tensor:
        """``W_mem memory``: (B, Tp, A) in ``dtype``, once per request."""
        return self.decoder.attention_layer.memory_layer(memory)

    def initial_state(self, b: int, tp: int) -> dict:
        """The decoder's zero state of b rows over tp encoder positions."""
        c, dev = self.cfg, self.device
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        return {"h1": z(b, c.attention_rnn_dim), "c1": z(b, c.attention_rnn_dim),
                "h2": z(b, c.decoder_rnn_dim), "c2": z(b, c.decoder_rnn_dim),
                "alpha": z(b, tp), "alpha_cum": z(b, tp), "ctx": z(b, c.encoder_embedding_dim)}

    def decoder_step(self, frame: torch.Tensor, state: dict, memory: torch.Tensor,
                     pm: torch.Tensor, valid: torch.Tensor, keep=None):
        """One decoder step from the previous frame (B, n_mels) fp32;
        ``state`` (``initial_state``) is updated in place.  ``keep``: the
        prenet's two (B, prenet_dim) keep masks and the kept elements' scale,
        or None for no dropout.  Returns the frame (B, n_mels) fp32, the
        stop logit (B,) fp32 and the attention weights (B, Tp) fp32."""
        d, dtype = self.decoder, self.dtype
        x = frame
        for i, layer in enumerate((d.prenet.LinearNorm_0, d.prenet.LinearNorm_1)):
            x = torch.relu(layer(x))
            if keep is not None:
                x = torch.where(keep[0][i], x * keep[1], torch.zeros_like(x))
        s = state
        s["h1"], s["c1"] = _lstm_cell(d.attention_rnn, torch.cat([x.float(), s["ctx"]], -1),
                                      s["h1"], s["c1"], dtype)
        alpha, s["ctx"] = d.attention_layer(s["h1"], memory, pm, valid, s["alpha"],
                                            s["alpha_cum"])
        s["alpha"], s["alpha_cum"] = alpha, s["alpha_cum"] + alpha
        s["h2"], s["c2"] = _lstm_cell(d.decoder_rnn, torch.cat([s["h1"], s["ctx"]], -1),
                                      s["h2"], s["c2"], dtype)
        hc = torch.cat([s["h2"], s["ctx"]], -1)
        return (d.linear_projection(hc).float(), d.gate_layer(hc).float()[:, 0], alpha)

    def apply_postnet(self, mel: torch.Tensor) -> torch.Tensor:
        return self.postnet(mel) + mel

    def forward(self, phoneme: torch.Tensor, melspec: torch.Tensor, phoneme_lens: torch.Tensor,
                prenet_keep=None) -> dict:
        """Teacher-forced pass, frame by frame: the decoder's input at step t
        is the target frame t - 1 (a zero go frame at 0).  ``prenet_keep(t)``
        gives step t's prenet masks (as ``decoder_step``'s ``keep``); None
        drops nothing.  Returns ``pred_melspec`` (B, T, n_mels),
        ``pred_stop`` (B, T), ``post_melspec`` and ``alignments`` (B, T, Tp),
        fp32."""
        memory = self.encode(phoneme, phoneme_lens)
        pm = self.process_memory(memory)
        b, tp = phoneme.shape
        valid = lengths_to_valid_mask(phoneme_lens, tp)
        state = self.initial_state(b, tp)
        frame = torch.zeros_like(melspec[:, 0]).float()
        mels, stops, aligns = [], [], []
        for t in range(melspec.shape[1]):
            mel, stop, alpha = self.decoder_step(
                frame, state, memory, pm, valid, prenet_keep(t) if prenet_keep else None)
            mels.append(mel)
            stops.append(stop)
            aligns.append(alpha)
            frame = melspec[:, t].float()
        pred = torch.stack(mels, 1)
        return {"pred_melspec": pred, "pred_stop": torch.stack(stops, 1),
                "post_melspec": self.apply_postnet(pred).float(),
                "alignments": torch.stack(aligns, 1)}
