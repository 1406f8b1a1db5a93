"""One home for deriving TransformerTTS runtime kwargs from a Config
(``transformertts_tpu/models/factory.py``), and for building the model that
``model.architecture`` names (``build_model``).

The JAX package gates its fused LayerNorm and fused FFN on ``d_model % 128``
and on the FFN's memory estimate (TPU lane and memory rules); the port has
no such gates: each CUDA kernel's wrapper raises for the widths it cannot
take.  ``use_pallas_fused_ffn`` is off by default, as in the JAX package.
On the GPU the fused ops are the CUDA kernels, and turning attention or the
fused LayerNorm off in the config has no GPU path: it raises, unless the
caller asks for the plain versions by name with ``plain_ops=True``.
"""

from __future__ import annotations

import torch

from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.models.tacotron2 import Tacotron2
from transformertts_tpu_torch.models.tts import TransformerTTS


def is_tacotron2(model_or_cfg) -> bool:
    """Whether a model, or a ``Config`` / ``ModelConfig``, is Tacotron 2."""
    if isinstance(model_or_cfg, Tacotron2):
        return True
    model_cfg = getattr(model_or_cfg, "model", model_or_cfg)
    return getattr(model_cfg, "architecture", None) == "tacotron2"


def build_model(cfg, dtype: torch.dtype, device: str | torch.device | None = None, **kwargs):
    """The model ``cfg.model.architecture`` names, in compute type ``dtype``
    on ``device`` (None: the GPU); ``kwargs`` go to ``TransformerTTS``."""
    if is_tacotron2(cfg):
        return Tacotron2(cfg.model, dtype=dtype, device=device)
    return TransformerTTS(cfg.model, dtype=dtype, device=device, **kwargs)


def runtime_model_kwargs(cfg, device: str | torch.device | None = None,
                         plain_ops: bool = False) -> dict:
    """kwargs for ``TransformerTTS(cfg.model, **runtime_model_kwargs(cfg))``;
    ``device`` None means the GPU."""
    r = cfg.runtime
    device = resolve_device(device)
    if device.type == "cuda" and not plain_ops:
        off = [name for name in ("use_pallas_attention", "use_pallas_fused_ln")
               if not getattr(r, name)]
        if off:
            raise ValueError(
                f"on CUDA training runs the attention and LayerNorm kernels; {off} = False "
                "has no GPU path (pass plain_ops=True to run the plain reference versions)")
    return dict(
        dtype=torch.bfloat16 if r.compute_dtype == "bfloat16" else torch.float32,
        device=device,
        use_flash=r.use_pallas_attention,
        use_fused_ln=r.use_pallas_fused_ln,
        use_fused_ffn=r.use_pallas_fused_ffn,
        fuse_qkv=r.fuse_qkv_projections,
        plain_ops=plain_ops,
    )
