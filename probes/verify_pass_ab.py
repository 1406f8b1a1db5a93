"""Same-call A/B of the verify pass of speculative decode between two trees.

    python3 probes/verify_pass_ab.py OLD_TREE NEW_TREE

Needs one Hopper GPU and nvcc.  Builds each tree's ``decode_step`` and
``decode_step_verify`` libraries (both trees at once, each into its own
``_build/``), then runs the trees in turns old, new, new, old, each in a
process of its own from its own root with its own modules and
``chip_smoke.py`` helpers: the B = 1 step and the verify pass at
``Config()`` (bf16 K 2, 4, 8; fp32 K 4) and ``configs/paper.yaml`` (bf16 K
4), 400 positions, 64 encoder positions, t 200, seeded random weights and
caches, device time by CUDA-graph replay (``chip_smoke.device_ms``).
Prints one ``AB <tree> ...`` line a time with the card's name and power
limit.  PERF.md quotes its output.
"""

import subprocess
import sys
from pathlib import Path

TIMING = r'''
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from transformertts_tpu_torch.ops import decode_step as ds

tag = sys.argv[1]
card = cs.card_line()
dev = torch.device("cuda")
t, n_pos, tp = 200, 400, 64
for what, cfg, cases in (("Config()", cs.default_config(),
                          (("bfloat16", 2), ("bfloat16", 4), ("bfloat16", 8), ("float32", 4))),
                         ("paper.yaml", cs.paper_config(), (("bfloat16", 4),))):
    for dname in dict.fromkeys(d for d, _ in cases):
        dtype = getattr(torch, dname)
        model = cs.make_model(cfg, dtype, dev, seed=1)
        packed = ds.pack_decode_weights(model, dtype)
        alpha = float(model.pe.alpha.detach())
        del model
        (frame, pe_row, bias), caches = cs.step_inputs(cfg, 1, t, n_pos, tp, dtype, dev, seed=7)
        pe_row = alpha * pe_row
        step = cs.device_ms(lambda: ds.decode_step(t, frame, pe_row, bias, *caches, packed)) * 1e3
        del caches
        print(f"AB {tag} {what} {dname} step B=1: {step:.1f} us [{card}]", flush=True)
        for k in (k for d, k in cases if d == dname):
            vc, rest = cs.verify_inputs(cfg, k, n_pos, tp, dtype, dev, 7, alpha)
            v = ds.DecodeVerify(*vc, packed, *rest, k=k, r=cfg.model.reduction_factor, n_pos=n_pos,
                                tau=1e9, stop_threshold=2.0)
            us = cs.device_ms(lambda: v(t)) * 1e3
            print(f"AB {tag} {what} {dname} verify K={k}: {us:.1f} us [{card}]", flush=True)
            del vc, rest, v
'''

BUILD = ("from transformertts_tpu_torch import _build; "
         "_build.build(['decode_step', 'decode_step_verify'])")


def main(old: str, new: str) -> int:
    trees = {"old": Path(old).resolve(), "new": Path(new).resolve()}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=root) for root in trees.values()]
    if any(p.wait() for p in builds):
        return 1
    for tag in ("old", "new", "new", "old"):
        run = subprocess.run([sys.executable, "-c", TIMING, tag], cwd=trees[tag])
        if run.returncode:
            return run.returncode
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
