#!/usr/bin/env python3
"""What a kernel-loop decode's ``decode.plan`` costs, piece by piece, cold
(nothing cached: the way every request paid it before the decode step was
prepared once per shape) and warm (the shape prepared before), on the card.

For each case (``ljspeech`` B 1 and 6, ``paper`` B 8; 576 positions, a
prompt bucket of 128 phonemes) it times, in ms with the device synchronised
after each:

- ``pe_numpy``: alpha times the float64-built 5,000-row table, uploaded
  (the old PE rows); ``pe_device``: ``pe_table`` from the model's table;
- ``decode_plan``: one plan of the case's clusters computed afresh, and
  ``card_plan_cold`` / ``card_plan_warm``: the cluster probing and plan
  with the memo emptied, then again;
- ``bias_per_slice``: the bias table with one host copy a slice (the old
  way), ``bias_one_copy``: from one host copy;
- ``kernel_rows_cold`` / ``kernel_rows_warm``: the whole ``KernelRows``
  (the ``decode.plan`` span) with every cache emptied, then again.

Each reading is the median of ``--repeat`` runs.  Prints one JSON line.

    python probes/plan_cost.py [--repeat 5]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CASES = (("ljspeech", 1), ("ljspeech", 6), ("paper", 8))
N_POS, TP = 576, 128


def _ms(fn, repeat: int) -> float:
    import torch

    out = []
    for _ in range(repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _bias_per_slice(biases, stage_rows, piece_rows, n_bias):
    import torch

    table = torch.zeros((stage_rows.shape[1], n_bias), dtype=torch.float32)
    for g in range(stage_rows.shape[1]):
        for s, bias in enumerate(biases):
            first, end, at, _ = (int(v) for v in stage_rows[s, g])
            if end > first:
                c0, c1 = int(piece_rows[first, g, 0]), int(piece_rows[end - 1, g, 1])
                table[g, at:at + c1 - c0] = bias[c0:c1].float().cpu()
    return table


def case(name: str, b: int, repeat: int, device) -> dict:
    import torch

    from portbench import harness
    from transformertts_tpu_torch.infer.decode import DecodeWeights, KernelRows, pe_table
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.models.masks import padding_bias
    from transformertts_tpu_torch.models.modules import sinusoid_table
    from transformertts_tpu_torch.ops import decode_step as ds

    cfg = harness.program_config(harness.config_spec(name), {"infer_max_len": N_POS})
    m = cfg.model
    model = TransformerTTS(m, dtype=torch.bfloat16, device=device)
    d_out = m.n_mels * m.reduction_factor + m.reduction_factor
    widths = (m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels, d_out)

    def forget():
        ds._plan_of.cache_clear()
        ds._card_plan_of.cache_clear()
        ds.self_chunks.cache_clear()

    out = {"config": name, "b": b}
    out["pe_numpy"] = _ms(lambda: (model.pe.alpha.float() * torch.from_numpy(
        sinusoid_table(m.max_len, m.d_model)).to(device)).float(), repeat)
    out["pe_device"] = _ms(lambda: pe_table(model, N_POS), repeat)
    cluster, rows, _ = ds.card_plan(*widths, b, m.decoder_n_head, N_POS, TP, torch.bfloat16)
    out["cluster"], out["rows"] = cluster, rows
    out["decode_plan"] = _ms(lambda: ds._plan_of.__wrapped__(
        *widths, rows, m.decoder_n_head, N_POS, 2, cluster), repeat)

    def card_cold():
        forget()
        ds.card_plan(*widths, b, m.decoder_n_head, N_POS, TP, torch.bfloat16)

    out["card_plan_cold"] = _ms(card_cold, repeat)
    out["card_plan_warm"] = _ms(
        lambda: ds.card_plan(*widths, b, m.decoder_n_head, N_POS, TP, torch.bfloat16), repeat)
    packed = DecodeWeights(model)()
    biases = ds.stage_biases(packed, m.decoder_n_layers)
    plan = ds.card_plan(*widths, b, m.decoder_n_head, N_POS, TP, torch.bfloat16)[2]
    out["bias_per_slice"] = _ms(lambda: _bias_per_slice(biases, *plan[:2], plan[2]["n_bias"])
                                .to(device), repeat)
    out["bias_one_copy"] = _ms(lambda: ds.bias_table(biases, *plan[:2], plan[2]["n_bias"])
                               .to(device), repeat)
    assert torch.equal(_bias_per_slice(biases, *plan[:2], plan[2]["n_bias"]),
                       ds.bias_table(biases, *plan[:2], plan[2]["n_bias"]))

    with torch.inference_mode():
        phoneme = torch.ones((b, TP), dtype=torch.long, device=device)
        lens = torch.full((b,), TP, dtype=torch.long, device=device)
        cross_kv = model.build_cross_cache(model.encode(phoneme, None))
        frames = torch.zeros((b, N_POS + 1, m.n_mels), device=device)
        stops = torch.zeros((b, N_POS), device=device)
        votes = torch.zeros((N_POS, b), dtype=torch.bool, device=device)
        args = (model, cfg, frames, stops, votes, cross_kv, padding_bias(lens, TP), N_POS, 2.0,
                0, 0.0)
        weights = DecodeWeights(model)
        weights()  # packed once: the pack is not part of a request's plan

        def rows_cold():
            forget()
            weights._cache["steps"].clear()
            weights._cache["pe"].clear()
            assert not KernelRows(*args, weights=weights).hit

        def rows_warm():
            assert KernelRows(*args, weights=weights).hit

        out["kernel_rows_cold"] = _ms(rows_cold, repeat)
        out["kernel_rows_warm"] = _ms(rows_warm, repeat)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeat", type=int, default=5)
    args = p.parse_args(argv)
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("plan_cost: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result = {"card": card, "n_pos": N_POS, "tp": TP,
              "cases": [case(name, b, args.repeat, device) for name, b in CASES]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
