"""The weights of a configuration, made from a seed on the device.

``param_shapes`` lists every tensor of the TransformerTTS checkpoint
format (the original recipe's modules under their flax names: embedding,
encoder prenet of conv + BatchNorm, decoder prenet, one scaled-PE scalar,
post-LN encoder and decoder layers, postnet, mel and stop heads) for the
model settings of a configuration file.  ``make_weights`` fills them with
one ``randn`` on the device and scales each tensor to a sane size: a matrix
or convolution to unit gain (std 1 / sqrt(fan_in)), LayerNorm and
BatchNorm scales near 1, small biases, BatchNorm running statistics near
(0, 1).  The benchmark hands the same dict to the program and to the
reference.
"""

from __future__ import annotations

import torch


def param_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """name -> shape of every parameter and BatchNorm statistic."""
    d, n_mels, r = m["d_model"], m["n_mels"], m.get("reduction_factor", 1)
    shapes: dict[str, tuple] = {"emb.weight": (m["n_phon"], d)}

    def conv_bn(prefix, c_in, c_out, k):
        shapes[f"{prefix}.Conv_0.weight"] = (c_out, c_in, k)
        shapes[f"{prefix}.Conv_0.bias"] = (c_out,)
        for name in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.BatchNorm_0.{name}"] = (c_out,)

    def linear(prefix, c_in, c_out):
        shapes[f"{prefix}.weight"] = (c_out, c_in)
        shapes[f"{prefix}.bias"] = (c_out,)

    for i in range(m["encoder_prenet_n_layers"]):
        conv_bn(f"enc_prenet.ConvBN_{i}", d, d, m["encoder_prenet_kernel_size"])
    linear("enc_prenet.LinearNorm_0.Dense_0", d, d)
    linear("dec_prenet.LinearNorm_0.Dense_0", n_mels, d)
    linear("dec_prenet.LinearNorm_1.Dense_0", d, d)
    shapes["pe.alpha"] = (1,)
    for side, attns in (("encoder", ("self_attn",)), ("decoder", ("self_attn", "cross_attn"))):
        f = m[f"{side}_d_ffn"]
        for i in range(m[f"{side}_n_layers"]):
            p = f"{side}.layer_{i}"
            for a in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    linear(f"{p}.{a}.{proj}", d, d)
            linear(f"{p}.ffn.Dense_0", d, f)
            linear(f"{p}.ffn.Dense_1", f, d)
            for j in range(1, len(attns) + 2):
                shapes[f"{p}.norm{j}.weight"] = (d,)
                shapes[f"{p}.norm{j}.bias"] = (d,)
    widths = [n_mels] + [d] * (m["postnet_n_layers"] - 1) + [n_mels]
    for i in range(m["postnet_n_layers"]):
        conv_bn(f"postnet.ConvBN_{i}", widths[i], widths[i + 1], m["postnet_kernel_size"])
    linear("mel_linear.Dense_0", d, n_mels * r)
    linear("stop_linear.Dense_0", d, r)
    return shapes


def _fill(name: str, t: torch.Tensor) -> None:
    """Scale a view of standard normals in place to the tensor's role."""
    leaf = name.rsplit(".", 1)[-1]
    if name == "emb.weight":
        return  # N(0, 1), as torch's nn.Embedding
    if t.dim() >= 2:  # (out, in) or (out, in, k)
        t.mul_(1.0 / (t[0].numel() ** 0.5))
    elif leaf == "running_var":
        t.mul_(0.2).exp_()
    elif leaf == "running_mean":
        t.mul_(0.1)
    elif leaf == "weight" or name == "pe.alpha":  # LayerNorm / BatchNorm scale, PE scalar
        t.mul_(0.1).add_(1.0)
    else:  # biases
        t.mul_(0.02)


@torch.no_grad()
def make_weights(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every tensor of ``param_shapes(m)`` in fp32 on ``device``, from
    ``seed`` by one ``torch.randn`` on a generator of that device."""
    shapes = param_shapes(m)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        t = part.view(shape)
        _fill(name, t)
        out[name] = t
    return out
