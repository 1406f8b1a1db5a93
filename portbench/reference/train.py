"""The recipe's training step in plain float32 PyTorch.

One optimizer step over K micro-batches: for each, a gradient-free
train-mode forward without the postnet gives predictions, block-wise
scheduled sampling mixes them into the decoder's inputs (Bernoulli(1 -
p_tf) seeds dilated to ``scheduled_sampling_block``-wide blocks, frames
past each length zeroed), then the train-mode forward and the loss
(masked MSE before and after the postnet, the latter weighted, and a stop
BCE with ``stop_weight`` on the last frame; guided attention when its
weight is on), and its backward.  The gradients are averaged over the
micro-batches, clipped to ``max_grad_norm``, L2 weight decay is added, and
Adam (0.9, 0.98, eps 1e-9) takes a Noam-scaled step.

Every random draw is the one the recipe's step makes for the same seeds:
per micro-batch three seeds from the caller's CPU generator (first pass,
second pass, mixing bits), the mixing bits from a device generator of the
third, the dropout of each pass from ``model.Drops``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.model import Drops, Plain, ident, no_tf32, shift_right


def ste(q):
    """``q`` in the forward, the identity in the backward."""
    if q is ident:
        return q
    return lambda x: x + (q(x) - x).detach()


def noam(d_model: int, warmup: int, step: int) -> float:
    s = float(max(step, 1))
    return d_model ** -0.5 * min(s ** -0.5, s * warmup ** -1.5)


def valid_mask(lens: torch.Tensor, t: int) -> torch.Tensor:
    return torch.arange(t, device=lens.device)[None, :] < lens[:, None]


def tts_loss(pred, post, stop, mel, lens, stop_weight, post_weight):
    valid = valid_mask(lens, pred.shape[1])
    frames = valid.sum().clamp(min=1)
    v3 = valid[:, :, None]
    zero = torch.zeros_like(pred)
    pred_l = torch.where(v3, (pred - mel) ** 2, zero).sum() / (frames * pred.shape[-1])
    post_l = torch.where(v3, (post - mel) ** 2, zero).sum() / (frames * pred.shape[-1])
    pos = torch.arange(pred.shape[1], device=lens.device)[None, :]
    gate = (pos >= (lens[:, None] - 1)).float()
    bce = stop_weight * gate * F.softplus(-stop) + (1.0 - gate) * F.softplus(stop)
    stop_l = torch.where(valid, bce, torch.zeros_like(bce)).sum() / frames
    return pred_l + post_weight * post_l + stop_l


def guided_loss(align, m_lens, p_lens, sigma):
    t_mel, t_phon = align.shape[-2:]
    dev = align.device
    t_norm = torch.arange(t_mel, device=dev)[None, :, None] / m_lens[:, None, None].clamp(min=1)
    n_norm = torch.arange(t_phon, device=dev)[None, None, :] / p_lens[:, None, None].clamp(min=1)
    w = 1.0 - torch.exp(-((n_norm - t_norm) ** 2) / (2.0 * sigma ** 2))
    valid = valid_mask(m_lens, t_mel)[:, :, None] & valid_mask(p_lens, t_phon)[:, None, :]
    pen = align * w[None, :, None]
    mask = valid[None, :, None].expand_as(pen)
    return torch.where(mask, pen, torch.zeros_like(pen)).sum() / mask.sum().clamp(min=1)


class Trainer:
    """The step's parameters (``params``, fp32 leaves), Adam's moments and
    count; ``weights`` as ``weights.make_weights`` gives them."""

    def __init__(self, config: dict, weights: dict, q=ident):
        no_tf32()
        self.c = config
        self.q = ste(q)
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
                       if not k.endswith(("running_mean", "running_var"))}
        self.stats = {k: v.detach().clone() for k, v in weights.items()
                      if k.endswith(("running_mean", "running_var"))}
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    def model(self) -> Plain:
        rt = self.c["runtime"]
        return Plain(self.c["model"], {**self.params, **self.stats}, q=self.q,
                     use_flash=rt["use_pallas_attention"], fused_ln=rt["use_pallas_fused_ln"])

    def micro(self, plain: Plain, b: dict, p_tf: float, seeds) -> torch.Tensor:
        """One micro-batch's loss; its gradients are added to the leaves."""
        lc, dev = self.c["loss"], plain.pe.device
        ids, mel = b["phoneme"], b["melspec"]
        p_lens, m_lens = b["phoneme_lens"], b["melspec_lens"]
        with torch.no_grad():
            drops = Drops(seeds[0], dev)
            memory = plain.encode(ids, p_lens, drops)
            x, _ = plain.decode(memory, shift_right(mel), p_lens, m_lens, drops)
            pred1, _ = plain.heads(x)
        gen = torch.Generator(device=dev).manual_seed(seeds[2])
        bits = torch.rand(mel.shape[:2], generator=gen, device=dev) < (1.0 - p_tf)
        l_bar = self.c["training"]["scheduled_sampling_block"]
        mask = F.max_pool1d(bits.float()[:, None, :], kernel_size=l_bar, stride=1,
                            padding=l_bar // 2)[:, 0, : mel.shape[1]] > 0.5
        mixed = torch.where(mask[:, :, None], pred1, mel)
        mixed = torch.where(valid_mask(m_lens, mel.shape[1])[:, :, None], mixed,
                            torch.zeros_like(mixed))
        align = lc["guided_attn_weight"] > 0.0
        drops = Drops(seeds[1], dev)
        memory = plain.encode(ids, p_lens, drops)
        x, al = plain.decode(memory, shift_right(mixed), p_lens, m_lens, drops, align=align)
        pred, stop = plain.heads(x)
        post = plain.postnet(pred, drops)
        loss = tts_loss(pred, post, stop, mel, m_lens, lc["stop_weight"], lc["post_mel_weight"])
        if align:
            loss = loss + lc["guided_attn_weight"] * guided_loss(al, m_lens, p_lens,
                                                                 lc["guided_attn_sigma"])
        loss.backward()
        return loss.detach()

    def step(self, batch: dict, p_tf: float, generator: torch.Generator) -> dict:
        """One optimizer step over ``batch`` (K micro-batches, tensors on the
        device).  Returns the mean loss, the gradient norm before clipping
        and the gradients as Adam gets them (clipped, decayed)."""
        t = self.c["training"]
        k = batch["phoneme"].shape[0]
        seeds = torch.randint(0, 2**62, (k, 3), generator=generator).tolist()
        for p in self.params.values():
            p.grad = None
        plain = self.model()
        losses = [self.micro(plain, {n: v[i] for n, v in batch.items()}, p_tf, seeds[i])
                  for i in range(k)]
        with torch.no_grad():
            grads = {n: (p.grad / k if p.grad is not None else torch.zeros_like(p))
                     for n, p in self.params.items()}
            norm = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()])))
            loss = float(torch.stack(losses).mean())
            if not (math.isfinite(norm) and math.isfinite(loss)):
                return {"loss": loss, "grad_norm": norm, "grads": grads, "skipped": True}
            if norm >= t["max_grad_norm"]:
                grads = {n: g / norm * t["max_grad_norm"] for n, g in grads.items()}
            if t["weight_decay"]:
                grads = {n: g + t["weight_decay"] * self.params[n] for n, g in grads.items()}
            lr = noam(self.c["model"]["d_model"], t["warmup_steps"], self.count)
            self.count += 1
            b1, b2, eps = 0.9, 0.98, 1e-9
            for n, p in self.params.items():
                g = grads[n]
                self.mu[n].mul_(b1).add_(g, alpha=1.0 - b1)
                self.nu[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (self.nu[n] / (1.0 - b2 ** self.count)).sqrt_().add_(eps)
                p.addcdiv_(self.mu[n], denom, value=-lr / (1.0 - b1 ** self.count))
        return {"loss": loss, "grad_norm": norm, "grads": grads, "skipped": False}
