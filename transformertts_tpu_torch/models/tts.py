"""The TransformerTTS model (``transformertts_tpu/models/tts.py``; ref:
model/model.py:138-394).

``forward`` is the teacher-forced pass: evaluation by default, training
(dropout on, BatchNorm on the batch's statistics and updating its running
ones) with ``train=True`` and a ``DropoutRng``.  The hooks below it serve the
KV-cached decode in ``infer/decode.py``.

A model that ``parallel.shard_state`` has sharded holds this rank's
parameters and runs on this rank's part of the batch (``shard_batch``):
its rows, and under sequence parallelism a time slice of mel and phoneme,
whose outputs are the same slices of the one-process outputs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transformertts_tpu_torch.config import ModelConfig
from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.models.masks import key_padding_bias
from transformertts_tpu_torch.models.modules import (
    DecoderPreNet,
    DropoutRng,
    Embed,
    EncoderPreNet,
    LinearNorm,
    PostNet,
    ScaledPositionalEncoding,
)
from transformertts_tpu_torch.models.transformer import Decoder, Encoder
from transformertts_tpu_torch.parallel import collectives
from transformertts_tpu_torch.parallel.mesh import SINGLE


def shift_right(mel: torch.Tensor, r: int = 1, layout=SINGLE) -> torch.Tensor:
    """Decoder inputs: zero go-frame then the last frame of each previous
    group of ``r`` frames (ref r=1 case: model/model.py:278-279).  Under
    sequence parallelism ``mel`` is a time slice: its first input is the
    previous slice's last frame (zeros on the first rank)."""
    go = torch.zeros_like(mel[:, :1, :])
    if layout.seq:
        mesh = layout.mesh
        with torch.no_grad():
            lasts = collectives.all_gather(mel[:, -1:, :], mesh.model_group, dim=1)
        if mesh.model_rank > 0:
            go = lasts[:, mesh.model_rank - 1: mesh.model_rank]
    prev_last = mel[:, r - 1:: r, :][:, :-1, :]
    return torch.cat([go, prev_last], dim=1)


def group_lens(mel_lens: torch.Tensor, r: int) -> torch.Tensor:
    """Frame lengths -> decoder-position lengths (ceil divide)."""
    return (mel_lens + r - 1) // r if r > 1 else mel_lens


class TransformerTTS(nn.Module):
    """Parameters are fp32; ``dtype`` is the compute dtype (bf16 or fp32).

    ``device`` None means the GPU (raises without one).  Weights are drawn
    on the CPU from ``generator`` (seed 0 when None) and then moved, so a
    seed gives the same weights on every device.  ``device="meta"`` builds
    the shapes only.

    ``use_flash`` / ``use_fused_ln`` / ``use_fused_ffn`` route attention,
    every ``LN(x + Drop(h))`` and every feed-forward block through the fused
    ops (``ops/flash_attention.py``, ``ops/fused_ln.py``,
    ``ops/fused_ffn.py``: the CUDA kernels on the GPU), ``fuse_qkv`` runs the
    in-projections as one matmul; ``models/factory.py`` derives them from a
    ``Config``.  ``plain_ops=True`` makes the fused ops run their plain
    PyTorch versions whatever the device: the reference a GPU run holds the
    kernels against.
    """

    layout = SINGLE

    def __init__(
        self,
        cfg: ModelConfig,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
        generator: Optional[torch.Generator] = None,
        use_flash: bool = False,
        use_fused_ln: bool = False,
        use_fused_ffn: bool = False,
        fuse_qkv: bool = False,
        plain_ops: bool = False,
    ):
        super().__init__()
        device = resolve_device(device)
        build = device if device.type == "meta" else torch.device("cpu")
        self.cfg = cfg
        self.dtype = dtype
        c, r = cfg, cfg.reduction_factor
        self.emb = Embed(c.n_phon, c.d_model, device=build)
        self.enc_prenet = EncoderPreNet(
            c.encoder_prenet_n_layers, c.d_model, c.encoder_prenet_kernel_size,
            c.encoder_prenet_dropout, dtype, device=build,
        )
        self.dec_prenet = DecoderPreNet(
            c.n_mels, c.d_model, c.decoder_prenet_dropout, dtype, device=build)
        self.pe = ScaledPositionalEncoding(c.d_model, c.max_len, c.pe_dropout, device=build)
        fused = (dtype, use_flash, use_fused_ln, fuse_qkv, plain_ops, use_fused_ffn)
        self.encoder = Encoder(
            c.encoder_n_layers, c.d_model, c.encoder_n_head, c.encoder_d_ffn,
            c.encoder_dropout, *fused, device=build,
        )
        self.decoder = Decoder(
            c.decoder_n_layers, c.d_model, c.decoder_n_head, c.decoder_d_ffn,
            c.decoder_dropout, *fused, device=build,
        )
        self.postnet = PostNet(
            c.postnet_n_layers, c.n_mels, c.d_model, c.postnet_kernel_size,
            c.postnet_dropout, dtype, device=build,
        )
        self.mel_linear = LinearNorm(c.d_model, c.n_mels * r, dtype=dtype, device=build)
        self.stop_linear = LinearNorm(c.d_model, r, dtype=dtype, device=build)
        if build.type != "meta":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            for m in self.modules():
                if m is not self and hasattr(m, "reset_parameters"):
                    m.reset_parameters(generator)
            self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.emb.weight.device

    def set_layout(self, layout) -> None:
        """Give every module that reads one this rank's ``parallel.mesh.Layout``
        (``shard_state`` calls it after slicing the parameters)."""
        for m in self.modules():
            if hasattr(m, "layout"):
                m.layout = layout

    def encode(self, phoneme: torch.Tensor, phoneme_lens: Optional[torch.Tensor],
               train: bool = False, rng: Optional[DropoutRng] = None):
        src_key_bias = (
            key_padding_bias(phoneme_lens, self.layout.time_total(phoneme.shape[1]))
            if phoneme_lens is not None else None
        )
        x = self.emb(phoneme).to(self.dtype)
        x = self.pe(self.enc_prenet(x, train, rng), 0, train, rng)
        return self.encoder(x, src_key_bias, train, rng)

    def decode(self, memory, tgt_in, phoneme_lens, mel_lens, return_alignments=True,
               train: bool = False, rng: Optional[DropoutRng] = None):
        t_pos = self.layout.time_total(tgt_in.shape[1])
        tgt_key_bias = (
            key_padding_bias(group_lens(mel_lens, self.cfg.reduction_factor), t_pos)
            if mel_lens is not None else None
        )
        mem_key_bias = (
            key_padding_bias(phoneme_lens, self.layout.time_total(memory.shape[1]))
            if phoneme_lens is not None else None
        )
        x = self.pe(self.dec_prenet(tgt_in.to(self.dtype), train, rng), 0, train, rng)
        return self.decoder(x, memory, tgt_key_bias, mem_key_bias, return_alignments, train, rng)

    def forward(
        self,
        phoneme: torch.Tensor,
        melspec: torch.Tensor,
        phoneme_lens: torch.Tensor,
        melspec_lens: torch.Tensor,
        return_alignments: bool = True,
        compute_postnet: bool = True,
        train: bool = False,
        rng: Optional[DropoutRng] = None,
    ) -> dict:
        """Teacher-forced forward (ref: model/model.py:260-320).

        ``compute_postnet=False`` skips the postnet (the first,
        gradient-free scheduled-sampling pass only needs ``pred_melspec``)."""
        r = self.cfg.reduction_factor
        b, t_mel = melspec.shape[0], melspec.shape[1]
        if t_mel % r:
            raise ValueError(f"mel length {t_mel} not a multiple of reduction_factor {r}")
        tgt_in = shift_right(melspec, r, self.layout)
        memory = self.encode(phoneme, phoneme_lens, train, rng)
        tgt_out, alignments = self.decode(
            memory, tgt_in, phoneme_lens, melspec_lens, return_alignments, train, rng
        )
        pred_melspec = self.mel_linear(tgt_out).reshape(b, t_mel, self.cfg.n_mels)
        pred_stop = self.stop_linear(tgt_out).reshape(b, t_mel)
        out = {
            "pred_melspec": pred_melspec.float(),
            "pred_stop": pred_stop.float(),
        }
        if compute_postnet:
            out["post_melspec"] = (self.postnet(pred_melspec, train, rng) + pred_melspec).float()
        if return_alignments:
            out["alignments"] = alignments.float()
        return out

    # --- hooks used by infer/decode.py ---

    def prenet_step(self, frame: torch.Tensor, step: int) -> torch.Tensor:
        """Decoder prenet + positional encoding for one input frame at
        decoder position ``step`` (group index when reduction_factor > 1)."""
        return self.pe(self.dec_prenet(frame.to(self.dtype)), offset=step)

    def build_cross_cache(self, memory: torch.Tensor):
        return [layer.project_cross_kv(memory) for layer in self.decoder.layers]

    def decode_frame_heads(self, x: torch.Tensor):
        """(B, k, d_model) -> mel frames (B, k*r, n_mels), stop logits (B, k*r)."""
        b = x.shape[0]
        mel = self.mel_linear(x).reshape(b, -1, self.cfg.n_mels)
        stop = self.stop_linear(x).reshape(b, -1)
        return mel, stop

    def apply_postnet(self, mel: torch.Tensor) -> torch.Tensor:
        return self.postnet(mel) + mel
