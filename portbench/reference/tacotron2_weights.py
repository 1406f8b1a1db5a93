"""The weights of a Tacotron 2 configuration, made from a seed on the device.

``param_shapes`` lists every tensor of the program's Tacotron 2 checkpoint
format (NVIDIA's modules, github.com/NVIDIA/tacotron2 ``model.py``, under
the program's names: the embedding, the encoder's convolutions with
BatchNorm and its BiLSTM, the decoder's bias-free prenet, the attention
LSTM cell, the location-sensitive attention, the decoder LSTM cell, the
projection and the gate, the postnet) for the model settings of a
configuration file.  ``make_weights`` fills them as ``weights.py`` does:
one ``randn`` on the device, each tensor scaled to its role (a matrix or
convolution to unit gain, std 1 / sqrt(fan_in); BatchNorm scales near 1
and running statistics near (0, 1); small biases; the embedding N(0, 1)).
The benchmark hands the same dict to the program and to the reference.
"""

from __future__ import annotations

import torch

from portbench.reference.weights import _fill


def param_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """name -> shape of every parameter and BatchNorm statistic."""
    e, n_mels, p = m["encoder_embedding_dim"], m["n_mels"], m["prenet_dim"]
    h1, h2, a = m["attention_rnn_dim"], m["decoder_rnn_dim"], m["attention_dim"]
    shapes: dict[str, tuple] = {"emb.weight": (m["n_phon"], m["symbols_embedding_dim"])}

    def conv_bn(prefix, c_in, c_out, k):
        shapes[f"{prefix}.Conv_0.weight"] = (c_out, c_in, k)
        shapes[f"{prefix}.Conv_0.bias"] = (c_out,)
        for name in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.BatchNorm_0.{name}"] = (c_out,)

    def cell(prefix, c_in, hidden, suffix=""):
        shapes[f"{prefix}.weight_ih{suffix}"] = (4 * hidden, c_in)
        shapes[f"{prefix}.weight_hh{suffix}"] = (4 * hidden, hidden)
        shapes[f"{prefix}.bias_ih{suffix}"] = (4 * hidden,)
        shapes[f"{prefix}.bias_hh{suffix}"] = (4 * hidden,)

    for i in range(m["encoder_n_convolutions"]):
        conv_bn(f"encoder.ConvBN_{i}", e, e, m["encoder_kernel_size"])
    cell("encoder.lstm", e, e // 2, "_l0")
    cell("encoder.lstm", e, e // 2, "_l0_reverse")
    shapes["decoder.prenet.LinearNorm_0.Dense_0.weight"] = (p, n_mels)
    shapes["decoder.prenet.LinearNorm_1.Dense_0.weight"] = (p, p)
    cell("decoder.attention_rnn", p + e, h1)
    cell("decoder.decoder_rnn", h1 + e, h2)
    att = "decoder.attention_layer"
    shapes[f"{att}.location_conv"] = (m["attention_location_n_filters"], 2,
                                      m["attention_location_kernel_size"])
    shapes[f"{att}.query_layer.Dense_0.weight"] = (a, h1)
    shapes[f"{att}.memory_layer.Dense_0.weight"] = (a, e)
    shapes[f"{att}.v.Dense_0.weight"] = (1, a)
    shapes[f"{att}.location_dense.Dense_0.weight"] = (a, m["attention_location_n_filters"])
    shapes["decoder.linear_projection.Dense_0.weight"] = (n_mels, h2 + e)
    shapes["decoder.linear_projection.Dense_0.bias"] = (n_mels,)
    shapes["decoder.gate_layer.Dense_0.weight"] = (1, h2 + e)
    shapes["decoder.gate_layer.Dense_0.bias"] = (1,)
    width = m["postnet_embedding_dim"]
    widths = [n_mels] + [width] * (m["postnet_n_layers"] - 1) + [n_mels]
    for i in range(m["postnet_n_layers"]):
        conv_bn(f"postnet.ConvBN_{i}", widths[i], widths[i + 1], m["postnet_kernel_size"])
    return shapes


def step_params(m: dict) -> int:
    """Parameters one decoder step reads (prenet, both cells with their
    biases, attention but the memory layer, projection and gate)."""
    keep = ("decoder.prenet", "decoder.attention_rnn", "decoder.decoder_rnn",
            "decoder.linear_projection", "decoder.gate_layer", "decoder.attention_layer")
    return sum(int(torch.Size(s).numel()) for n, s in param_shapes(m).items()
               if n.startswith(keep) and "memory_layer" not in n)


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
