"""``counts.py`` against sums worked out by hand at one small shape per
kernel family, and the decode step's weight count against the program's
packed weights."""

import pytest

from portbench import counts, harness

TINY = {"d_model": 2, "decoder_d_ffn": 4, "n_mels": 1, "decoder_n_layers": 1,
        "decoder_n_head": 1, "reduction_factor": 1}


def test_decode_step_by_hand():
    # bf16: prenet 2*1+2 + 2*2+2 = 10; heads (1+1)*2 + 2 = 6; layer: qkv 3*4+6 = 18,
    # self out / cross q / cross out 3*(4+2) = 18, ffn 4*2+4 + 2*4+2 = 22 -> 58;
    # LayerNorm 6*2 = 12 fp32
    assert counts.decode_weights(TINY) == (74 + 12, 2 * 74 + 4 * 12)
    # b 1, t 3, tp 2: cache 2*1*1*1*(3+2)*2*2 = 40; io 4*(1+2+2+1) + 4*2 + 2*1*1*1*2*2 = 40
    nbytes, flops = counts.decode_step_bytes_flops(TINY, 1, 3, 2)
    assert nbytes == 196 + 40 + 40
    assert flops == 2 * 86 + 4 * 1 * 1 * 2 * (3 + 1 + 2)


def test_flash_by_hand():
    # b 1, h 1, dh 2, (2, 2), all 4 pairs: Q,O 8 B each, K,V 8 B each, bias 8 B, m,l 8 B each
    assert counts.flash_bytes_flops(1, 1, 2, 2, 2, 4) == (56.0, 32.0)
    assert counts.flash_bytes_flops(1, 1, 2, 2, 2, 4, backward=True) == (88.0, 80.0)
    assert counts._pairs([2], [2], True, 2) == 3 and counts._pairs([2], [1], False, 2) == 2


def test_layernorm_by_hand():
    assert counts.ln_bytes_flops(2, 4) == (80.0, 80.0)
    assert counts.ln_bytes_flops(2, 4, backward=True) == (128.0, 160.0)


def test_forward_flops_by_hand():
    m = {"d_model": 2, "n_mels": 1, "encoder_d_ffn": 4, "decoder_d_ffn": 4,
         "encoder_prenet_kernel_size": 1, "encoder_prenet_n_layers": 1, "encoder_n_layers": 1,
         "decoder_n_layers": 1, "postnet_kernel_size": 1, "postnet_n_layers": 2}
    # p 1, t 1: enc prenet 8 + 8; enc layer 32 + 8 + 32; dec prenet 4 + 8;
    # dec layer 32 + 8 + 16 + 16 + 8 + 32; heads 8; postnet 4 + 4
    assert counts.forward_flops(m, 1, 1, False) == 16 + 72 + 12 + 112 + 8
    assert counts.forward_flops(m, 1, 1, True) == 16 + 72 + 12 + 112 + 8 + 8


def test_bound_picks_the_larger_side():
    assert counts.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert counts.bound_by(0.0, 989e12) == "operations"


@pytest.mark.parametrize("name", ["ljspeech", "paper"])
def test_decode_weights_match_the_packed_weights(name):
    import torch

    from transformertts_tpu_torch.config import config_from_dict
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.ops.decode_step import pack_decode_weights

    m = harness.config_spec(name)["model"]
    packed = pack_decode_weights(TransformerTTS(config_from_dict({"model": m}).model,
                                                device="cpu"), torch.bfloat16)
    assert counts.decode_weights(m) == (sum(p.numel() for p in packed.values()),
                                        sum(p.numel() * p.element_size() for p in packed.values()))
