"""Tacotron 2's decoder step for the yardstick: its bytes and operations
from the shapes, by ``counts.py``'s convention (each input read once and
each output written once, at 3.35 TB/s, against the operations at 989
TFLOP/s bf16; the larger is the bound).

A step of b rows over tp encoder positions reads the step's parameters
(prenet, both LSTM cells with their biases, the attention's query,
location and ``v`` layers, the projection and the gate: 18.19 M at
NVIDIA's widths) in bf16, the encoder memory and the processed memory of
its rows in bf16, and reads and writes its recurrent state (both cells'
h and c, the attention weights and their running sum, the context) in
fp32; it reads the previous frame and writes the frame and the stop logit.
Its operations are two a weight a row for the products, the location
convolution and dense layer, the energies' dot with ``v`` and the context
over every encoder position.
"""

from __future__ import annotations

from portbench.counts import bound_s
from portbench.reference.tacotron2_weights import step_params


def step_bytes_flops(m: dict, b: int, tp: int) -> tuple[float, float]:
    e, a = m["encoder_embedding_dim"], m["attention_dim"]
    n_f, k = m["attention_location_n_filters"], m["attention_location_kernel_size"]
    h1, h2, n_mels = m["attention_rnn_dim"], m["decoder_rnn_dim"], m["n_mels"]
    n_w = step_params(m)
    state = 4 * b * 2 * (2 * h1 + 2 * h2 + 2 * tp + e)  # read and written, fp32
    io = 4 * b * (n_mels + n_mels + 1)
    nbytes = 2 * n_w + 2 * b * tp * (e + a) + state + io
    conv_params = n_f * 2 * k
    flops = 2 * b * (n_w - conv_params) + 2 * b * tp * (conv_params + n_f * a + a + e)
    return float(nbytes), float(flops)


def step_bound_s(m: dict, b: int, tp: int) -> float:
    return bound_s(*step_bytes_flops(m, b, tp))


def decode_bound_s(m: dict, b: int, tp: int, steps: int) -> float:
    """Summed bound of ``steps`` steps of b rows over tp positions (every
    step of a decode reads the same)."""
    return steps * step_bound_s(m, b, tp)
