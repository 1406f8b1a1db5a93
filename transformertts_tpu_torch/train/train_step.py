"""Training and evaluation steps (``transformertts_tpu/train/train_step.py``).

One call of the train step is one optimizer step over ``grad_acc_steps``
micro-batches (the leading K axis of every batch array): gradients are
summed over the micro-batches and divided by K, then clipped to global norm
1.0, then L2 weight decay is added to the clipped gradient, then
Adam(0.9, 0.98, eps 1e-9) scaled by the Noam rate (optax's order of
``clip_by_global_norm -> add_decayed_weights -> scale_by_adam ->
scale_by_schedule -> scale(-1)``).

Scheduled sampling is the reference's two-forward recipe: a gradient-free
train-mode forward (dropout on, BatchNorm running statistics updated, no
postnet) gives ``pred_melspec``, block-wise mixing replaces ground-truth
frames, then the real forward and the loss.  BatchNorm therefore updates its
running statistics twice per micro-batch.

PyTorch idiom where the JAX step was functional: the model holds the
parameters and is updated in place; gradients accumulate in ``.grad``; the
dropout masks and the mixing bits come from explicit generators seeded, per
micro-batch, from the CPU ``torch.Generator`` the caller passes (which the
step advances).  A step whose loss or gradient norm is not finite changes
nothing (parameters, moments, BatchNorm statistics, EMA, step count of the
optimizer); deciding that costs the step's one device-to-host readback.  The
port has one optimizer: ``runtime.fused_optimizer`` only changed dispatch in
the JAX package and is not read here.

On a model sharded by ``parallel.shard_state`` the step runs on this rank's
part of the batch (``parallel.shard_batch``) and ends as the one-process
step does: each rank's loss is its part of the global masked sums, so the
gradients are summed over the data ranks (and, under sequence parallelism,
the replicated parameters' over the model ranks too), the metrics are
summed likewise, the global gradient norm counts each sharded parameter's
squares over the model ranks and each replicated one once, and every rank
then reads the same norm and loss and skips, or not, together.

Spans (``utils/trace.py``): ``train.step`` (``micro``; ``frames``: the
padded mel frames) holds one ``train.micro`` per micro-batch
(``train.forward_free``, the gradient-free forward and the mixing, under
scheduled sampling; ``train.forward``, the forward and the loss;
``train.backward``), then ``train.grads`` (divide, sum over ranks, norm),
``train.readback`` (the non-finite guard's readback: the host's wait for the
device) and ``train.optimizer`` (the update and the EMA).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from transformertts_tpu_torch.config import Config
from transformertts_tpu_torch.models.masks import lengths_to_valid_mask
from transformertts_tpu_torch.models.modules import BatchNorm, DropoutRng
from transformertts_tpu_torch.models.tts import TransformerTTS
from transformertts_tpu_torch.parallel import collectives
from transformertts_tpu_torch.parallel.mesh import param_spec, split_dim
from transformertts_tpu_torch.train.loss import (
    alignment_diagonality,
    guided_attention_loss,
    tts_loss,
)
from transformertts_tpu_torch.train.metrics import mel_cepstral_distortion, stop_token_metrics
from transformertts_tpu_torch.train.sampling import apply_teacher_forcing
from transformertts_tpu_torch.train.schedules import noam_schedule
from transformertts_tpu_torch.utils import trace


@dataclasses.dataclass
class TrainState:
    step: int  # optimizer steps attempted (a skipped step counts, as in the JAX package)
    model: TransformerTTS  # holds the parameters and the BatchNorm statistics
    opt_state: dict  # {"count": int, "mu": {name: tensor}, "nu": {name: tensor}}
    ema_params: Optional[dict] = None  # {name: tensor} when training.ema_decay > 0

    @property
    def eval_params(self) -> dict:
        """Parameters for validation/inference: the EMA copy when one is
        maintained, else the live parameters."""
        if self.ema_params is not None:
            return self.ema_params
        return dict(self.model.named_parameters())


class AdamNoam:
    """clip(global norm) -> + weight_decay * param -> Adam -> x Noam(count) -> x -1,
    on dicts of tensors keyed by parameter name."""

    def __init__(self, d_model: int, warmup_steps: int, max_grad_norm: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.98, eps: float = 1e-9):
        self.schedule = noam_schedule(d_model, warmup_steps)
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def apply_(self, params: dict, grads: dict, state: dict, grad_norm: float) -> None:
        """Update ``params`` and ``state`` in place from the averaged,
        unclipped ``grads`` whose global norm is ``grad_norm``."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        if grad_norm >= self.max_grad_norm:  # optax: (g / norm) * max_norm, no epsilon
            g = torch._foreach_mul(torch._foreach_div(g, grad_norm), self.max_grad_norm)
        if self.weight_decay:
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = state["count"] + 1
        lr = self.schedule(state["count"])  # evaluated at the count BEFORE this update
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(p, mu, denom, value=-lr / (1.0 - self.b1 ** count))
        state["count"] = count


def make_optimizer(cfg: Config) -> AdamNoam:
    t = cfg.training
    return AdamNoam(cfg.model.d_model, t.warmup_steps, t.max_grad_norm, t.weight_decay)


def create_train_state(model: TransformerTTS, cfg: Config, optimizer=None) -> TrainState:
    """Fresh optimizer state (and EMA copy) around an initialised model."""
    optimizer = optimizer or make_optimizer(cfg)
    params = dict(model.named_parameters())
    return TrainState(
        step=0,
        model=model,
        opt_state=optimizer.init(params),
        ema_params=({k: p.detach().clone() for k, p in params.items()}
                    if cfg.training.ema_decay > 0.0 else None),
    )


def _to_device(batch: dict, device, k: Optional[int] = None) -> dict:
    """The batch (or its micro-batch ``k``) as tensors on ``device``."""
    out = {}
    for name, x in batch.items():
        x = torch.as_tensor(x if k is None else x[k]).to(device)
        out[name] = x.float() if x.is_floating_point() else x.long()
    return out


def _batch_stats(model) -> dict:
    return {f"{name}.{buf}": getattr(m, buf)
            for name, m in model.named_modules() if isinstance(m, BatchNorm)
            for buf in ("running_mean", "running_var")}


def _micro_loss(model: TransformerTTS, cfg: Config, batch: dict, p_tf: float, seeds,
                scheduled_sampling: bool, ga_w=None):
    """Forward(s) and backward of one micro-batch: gradients are ADDED to the
    parameters' ``.grad``.  ``seeds``: three ints (first pass, real pass,
    mixing bits).  Returns (losses, the decoder's mixed inputs)."""
    device = model.device
    phoneme, melspec = batch["phoneme"], batch["melspec"]
    p_lens, m_lens = batch["phoneme_lens"], batch["melspec_lens"]

    layout = model.layout
    target_in = melspec
    if scheduled_sampling:
        with trace.span("train.forward_free"), torch.no_grad():
            # forward #1: train mode, no gradient, no postnet
            out1 = model(phoneme, melspec, p_lens, m_lens, return_alignments=False,
                         compute_postnet=False, train=True, rng=DropoutRng(seeds[0], device))
            mix_rng = torch.Generator(device=device).manual_seed(seeds[2])
            target_in = apply_teacher_forcing(
                mix_rng, out1["pred_melspec"], melspec, m_lens, p_tf,
                cfg.training.scheduled_sampling_block, layout)

    need_align = cfg.loss.guided_attn_weight > 0.0
    if ga_w is None:
        ga_w = cfg.loss.guided_attn_weight
    with trace.span("train.forward"):
        out = model(phoneme, target_in, p_lens, m_lens, return_alignments=need_align,
                    train=True, rng=DropoutRng(seeds[1], device))
        losses = tts_loss(out, melspec, m_lens, cfg.loss.stop_weight, cfg.loss.post_mel_weight,
                          cfg.loss.stop_gate_k, layout)
        total = losses["total"]
        if need_align:
            ga = guided_attention_loss(out["alignments"], m_lens, p_lens,
                                       cfg.loss.guided_attn_sigma, layout)
            losses["guided_attn"] = ga
            total = total + ga_w * ga
        losses["total"] = total
    with trace.span("train.backward"):
        total.backward()
    return {k: v.detach() for k, v in losses.items()}, target_in


def _sum_grads(layout, grads: dict) -> None:
    """Sum the gradients in place over the ranks that hold other parts of
    the batch: every gradient over the data ranks; under sequence
    parallelism the replicated parameters' over the model ranks as well (a
    sharded parameter's gradient is whole on its rank already).  One
    all-reduce of a flat buffer per group."""
    mesh = layout.mesh
    groups = [(mesh.data_group, list(grads))] if mesh.n_data > 1 else []
    if layout.seq:
        groups.append((mesh.model_group,
                       [k for k in grads if split_dim(param_spec(k, True)) is None]))
    for group, names in groups:
        flat = collectives.all_reduce(torch.cat([grads[k].reshape(-1) for k in names]), group)
        for k, part in zip(names, flat.split([grads[k].numel() for k in names])):
            grads[k] = part.view_as(grads[k])


def _global_norm(layout, grads: dict) -> torch.Tensor:
    """The gradient norm of the one-process step: each replicated
    parameter's squares once, each sharded one's summed over the model
    ranks."""
    norms = torch.stack(torch._foreach_norm(list(grads.values())))
    if not layout.tp:
        return torch.linalg.vector_norm(norms)
    split = torch.tensor([split_dim(param_spec(k, True)) is not None for k in grads],
                         device=norms.device)
    sq = norms * norms
    sharded = collectives.all_reduce(sq[split].sum(), layout.mesh.model_group)
    return torch.sqrt(sq[~split].sum() + sharded)


def make_train_step(
    model: TransformerTTS,
    cfg: Config,
    optimizer: Optional[AdamNoam] = None,
    scheduled_sampling: bool = True,
    return_mixed_inputs: bool = False,
) -> Callable:
    """Returns fn(state, batch, p_tf, generator, ga_w=None) -> (state, metrics).

    ``batch`` arrays (numpy or tensors) carry a leading ``grad_acc_steps``
    axis: phoneme (K, B, T_p) int; melspec (K, B, T_m, n_mels) float;
    phoneme_lens / melspec_lens (K, B) int.  ``generator`` is a CPU
    ``torch.Generator``; every dropout mask and mixing bit of the step
    derives from the seeds drawn from it.  ``ga_w`` overrides
    ``cfg.loss.guided_attn_weight``.  The state is updated in place and
    returned; metrics are 0-d tensors on the model's device.

    ``return_mixed_inputs=True`` additionally returns the scheduled-sampling
    mixed decoder inputs of the FIRST micro-batch, (B, T_m, n_mels).
    """
    if cfg.model.architecture != "transformer_tts":
        raise ValueError(f"model.architecture {cfg.model.architecture} has no train step yet: "
                         "training is ported for transformer_tts only")
    optimizer = optimizer or make_optimizer(cfg)
    decay = cfg.training.ema_decay

    def step_fn(state: TrainState, batch: dict, p_tf: float, generator: torch.Generator,
                ga_w=None):
        if state.model is not model:
            raise ValueError("the state belongs to another model than this step")
        k = len(batch["phoneme"])
        mel_shape = batch["melspec"].shape  # (K, B, T_m, n_mels)
        with trace.span("train.step", micro=k, frames=k * mel_shape[1] * mel_shape[2]):
            params = dict(model.named_parameters())
            stats = _batch_stats(model)
            old_stats = {name: buf.clone() for name, buf in stats.items()}
            model.zero_grad(set_to_none=True)
            seeds = torch.randint(0, 2**62, (k, 3), generator=generator).tolist()

            losses, mixed = [], None
            for i in range(k):
                with trace.span("train.micro"):
                    micro_losses, target_in = _micro_loss(
                        model, cfg, _to_device(batch, model.device, i), p_tf, seeds[i],
                        scheduled_sampling, ga_w)
                losses.append(micro_losses)
                if i == 0:
                    mixed = target_in

            layout = model.layout
            with trace.span("train.grads"):
                names = [name for name, p in params.items() if p.grad is not None]
                grads = dict(zip(names, torch._foreach_div([params[n].grad for n in names],
                                                           float(k))))
                for name, p in params.items():  # a parameter the loss never reached
                    if name not in grads:
                        grads[name] = torch.zeros_like(p)
                grads = {name: grads[name] for name in params}  # one order on every rank
                _sum_grads(layout, grads)
                metrics = {name: torch.stack([m[name] for m in losses]).mean()
                           for name in losses[0]}
                metrics = dict(zip(metrics, layout.total(torch.stack(list(metrics.values())))))
                grad_norm = _global_norm(layout, grads)
                metrics["grad_norm"] = grad_norm

            # failure detection: a non-finite step is skipped wholesale (the one readback)
            with trace.span("train.readback"):
                norm_host, total_host = torch.stack([grad_norm, metrics["total"]]).tolist()
            ok = math.isfinite(norm_host) and math.isfinite(total_host)
            metrics["skipped"] = torch.tensor(0.0 if ok else 1.0, device=model.device)
            if ok:
                with trace.span("train.optimizer"):
                    optimizer.apply_(params, grads, state.opt_state, norm_host)
                    if state.ema_params is not None:  # EMA trails the POST-update parameters
                        with torch.no_grad():
                            ema = [state.ema_params[n] for n in params]
                            torch._foreach_mul_(ema, decay)
                            torch._foreach_add_(ema, [p.detach() for p in params.values()],
                                                alpha=1.0 - decay)
            else:
                with torch.no_grad():
                    for name, buf in stats.items():
                        buf.copy_(old_stats[name])
            model.zero_grad(set_to_none=True)
            state.step += 1
        if return_mixed_inputs:
            return state, metrics, mixed
        return state, metrics

    return step_fn


def make_eval_step(model: TransformerTTS, cfg: Config, with_outputs: bool = False) -> Callable:
    """Teacher-forced validation step (ref: lightning_module.py:102-131) on
    the state's ``eval_params``.  The model holds whole parameters: a
    sharded model is evaluated through a copy that holds the gathered ones
    (``parallel.mesh.gather_state``), as ``Trainer`` does."""
    if model.layout.sharded:
        raise ValueError("make_eval_step needs a model with whole parameters; load the "
                         "gathered ones (parallel.mesh.gather_state) into an unsharded copy")

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: dict):
        b = _to_device(batch, model.device)
        args = (b["phoneme"], b["melspec"], b["phoneme_lens"], b["melspec_lens"])
        if state.ema_params is None:
            out = model(*args, return_alignments=True)
        else:
            out = torch.func.functional_call(
                model, {**dict(model.named_buffers()), **state.ema_params}, args,
                {"return_alignments": True})
        losses = tts_loss(out, b["melspec"], b["melspec_lens"], cfg.loss.stop_weight,
                          cfg.loss.post_mel_weight, cfg.loss.stop_gate_k)
        metrics = dict(losses)
        metrics["diagonality"] = alignment_diagonality(
            out["alignments"], b["melspec_lens"], b["phoneme_lens"])
        mel_l1 = (out["post_melspec"] - b["melspec"]).abs()
        valid = lengths_to_valid_mask(b["melspec_lens"], mel_l1.shape[1])[:, :, None]
        metrics["mel_l1"] = torch.where(valid, mel_l1, torch.zeros_like(mel_l1)).sum() / (
            valid.sum() * mel_l1.shape[-1]).clamp(min=1)
        metrics["mcd"] = mel_cepstral_distortion(
            out["post_melspec"], b["melspec"], b["melspec_lens"])
        metrics.update(stop_token_metrics(out["pred_stop"], b["melspec_lens"]))
        if with_outputs:
            return metrics, out
        return metrics

    return eval_fn


def count_params(model_or_params) -> int:
    params = (model_or_params.parameters() if isinstance(model_or_params, torch.nn.Module)
              else model_or_params.values())
    return sum(int(p.numel()) for p in params)
