"""Training on a bucketed corpus: the optimizer step of ``make_train_step``
fed as ``Trainer.fit`` feeds it (``BucketedLoader`` over npz files, the
native reader, ``prefetch``, ``batch_to_device``), scheduled sampling with
the double forward, dropout on.

Parameters: ``clips`` in the corpus; ``frames`` (mean, std, low, high) of
the mel lengths and ``frames_per_phoneme`` with its relative ``spread``
for the phoneme lengths (clipped to ``phonemes`` low, high); ``p_tf`` the
teacher-forcing ratio; ``shape_seed`` of the fixed lengths; ``n_checked``
steps the reference follows; ``profile_steps``; ``limits``.

The corpus (random normalized mels and phoneme ids, from ``--seed``) is
written as uncompressed npz files under ``$TMPDIR`` in set-up and removed
at the end.  The first ``n_checked`` steps are the warm-up; the window then
runs whole steps until ``--seconds`` have passed.
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import counts, harness, textgen
from portbench.reference.train import Trainer
from portbench.reference.weights import make_weights


def corpus_lengths(p) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(p["shape_seed"])
    mean, std, lo, hi = p["frames"]
    m = np.clip(np.rint(rng.normal(mean, std, p["clips"])), lo, hi).astype(np.int64)
    ph = m / p["frames_per_phoneme"] * (1.0 + p["spread"] * rng.normal(size=p["clips"]))
    return np.clip(np.rint(ph), *p["phonemes"]).astype(np.int64), m


def write_corpus(ctx, root) -> list[tuple[np.ndarray, np.ndarray]]:
    """The clips (ids, (n_mels, T) mel) in ``root``; lengths fixed by the
    cell, their order and contents by ``--seed``."""
    p = ctx.params
    p_lens, m_lens = corpus_lengths(p)
    order = textgen.run_rng(ctx.seed, 5).permutation(len(p_lens))
    rng = textgen.run_rng(ctx.seed, 6)
    n_mels = ctx.config["model"]["n_mels"]
    mels = rng.standard_normal((n_mels, int(m_lens.sum())), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(m_lens[order])])
    clips = []
    for j, i in enumerate(order):
        ids = rng.integers(4, 84, size=int(p_lens[i]), dtype=np.int32)
        mel = np.ascontiguousarray(mels[:, starts[j]: starts[j + 1]])
        np.savez(f"{root}/clip{j:05d}.npz", sequence=ids, melspec=mel)
        clips.append((ids, mel))
    return clips


def rows_mismatch(batch: dict, by_ids: dict) -> int:
    """Rows of a loader batch that are not a corpus clip, zero padded."""
    bad = 0
    for k in range(batch["phoneme"].shape[0]):
        for r in range(batch["phoneme"].shape[1]):
            pl, ml = int(batch["phoneme_lens"][k, r]), int(batch["melspec_lens"][k, r])
            if ml == 0:
                continue  # a repeat-padded row, masked out of the loss
            ids = batch["phoneme"][k, r]
            clip = by_ids.get(ids[:pl].tobytes())
            mel = batch["melspec"][k, r]
            if (clip is None or ml != clip[1].shape[1] or np.any(ids[pl:])
                    or not np.array_equal(mel[:ml], clip[1].T) or np.any(mel[ml:])):
                bad += 1
    return bad


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """Worst leaf's |prog norm - ref norm| over max(ref norm, the median
    leaf's ref norm); ``keep`` names the leaves compared."""
    names = [n for n in ref if keep is None or n in keep]
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def run(ctx) -> dict:
    from transformertts_tpu_torch.data.dataset import BucketedLoader, LJSpeechDataset
    from transformertts_tpu_torch.data.prefetch import batch_to_device, prefetch
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.models.factory import runtime_model_kwargs
    from transformertts_tpu_torch.train.train_step import create_train_state, make_train_step

    p = ctx.params
    cfg = harness.program_config(ctx.config)
    m = ctx.config["model"]
    t = cfg.training
    root = tempfile.mkdtemp(prefix="portbench-corpus-")
    try:
        clips = write_corpus(ctx, root)
        by_ids = {ids.tobytes(): c for ids, c in ((c[0], c) for c in clips)}
        weights = make_weights(m, ctx.seed, ctx.device)
        model = TransformerTTS(cfg.model, **runtime_model_kwargs(cfg, ctx.device))
        model.load_state_dict(weights, strict=True)
        state = create_train_state(model, cfg)
        step_fn = make_train_step(model, cfg, scheduled_sampling=True)
        loader = BucketedLoader(
            LJSpeechDataset(root, "train"), t.batch_size, cfg.runtime.phoneme_buckets,
            cfg.runtime.mel_buckets, n_mels=m["n_mels"], grad_acc_steps=t.grad_acc_steps,
            shuffle=True, drop_last=True, seed=int(textgen.run_rng(ctx.seed, 7).integers(1 << 30)),
            n_threads=t.num_workers)
        gen = torch.Generator().manual_seed(int(textgen.run_rng(ctx.seed, 8).integers(1 << 62)))
        gen_state = gen.get_state()
        epoch = [0]
        batches = [prefetch(loader.epoch(0))]

        def next_batch():
            while True:
                b = next(batches[0], None)
                if b is not None:
                    return b
                epoch[0] += 1
                batches[0] = prefetch(loader.epoch(epoch[0]))

        def one_step():
            """The fed step: (host batch, metrics, seconds waiting on the loader)."""
            w0 = time.perf_counter()
            batch = next_batch()
            wait = time.perf_counter() - w0
            nonlocal state
            state, metrics = step_fn(state, batch_to_device(batch, ctx.device), p["p_tf"], gen)
            return batch, metrics, wait

        # the checked steps are the warm-up: the reference follows them
        checked, losses = [], []
        for k in range(p["n_checked"]):
            batch, metrics, _ = one_step()
            checked.append(batch)
            losses.append(metrics["total"])
            if k == 0:
                mu1 = {n: v.detach().clone() for n, v in state.opt_state["mu"].items()}
        params_after = {n: v.detach().clone() for n, v in model.named_parameters()}
        prof = harness.DeviceProfile() if ctx.trace and ctx.device.type == "cuda" else None
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.time() - ctx.t_start

        harness.note(ctx, "window opens")
        frames = steps = 0
        skipped = []
        clean_s = clean_wait = 0.0
        clean_micro, prof_micro = [], []
        t0 = time.perf_counter()
        while True:
            s0 = time.perf_counter()
            clean = prof is None or prof.prof is None  # what spans read comes from before it
            if clean and prof is not None and s0 >= t0 + 0.6 * ctx.seconds:
                prof.start()  # the first start in a process takes seconds
                clean = False
            profiled = prof is not None and prof.running
            batch, metrics, wait = one_step()
            s1 = time.perf_counter()
            skipped.append(metrics["skipped"])
            steps += 1
            frames += int(batch["melspec_lens"].sum())
            micro = [(batch["phoneme"].shape[1], batch["phoneme"].shape[2],
                      batch["melspec"].shape[2], batch["phoneme_lens"][i].tolist(),
                      batch["melspec_lens"][i].tolist()) for i in range(batch["phoneme"].shape[0])]
            if clean:
                clean_s += s1 - s0
                clean_wait += wait
                clean_micro += micro
            if profiled:
                prof_micro += micro
                if len(prof_micro) >= p["profile_steps"] * len(micro):
                    prof.stop()
            if s1 - t0 >= ctx.seconds:
                break
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
        harness.note(ctx, "window closed")
        prog_losses = [float(x) for x in losses]
        rec = {
            "setup_s": setup_s,
            "attempted": steps,
            "failed": int(sum(float(x) for x in skipped)),
            "memory_peak_bytes": peak,
            "window_s": window,
            "train_frames": frames,
            "hop_s": ctx.config["audio"]["hop_length"] / ctx.config["audio"]["sample_rate"],
            "loader_wait_s": clean_wait,
            "clean_s": clean_s,
            "mfu_flops": sum(counts.train_micro_flops(m, pl, ml) for *_, pl, ml in clean_micro),
        }
        if prof is not None and prof.prof is not None:
            if prof.running:
                prof.stop()
            rec["profile"] = prof.summary()
            rec["profile"]["bounds"] = counts.train_kernel_bounds(
                m, prof_micro, ctx.config["loss"]["guided_attn_weight"] == 0.0)
        del model, state, step_fn, metrics, batches
        harness.free_device()
        harness.note(ctx, "profile read, check starts")
        rec["checks"], rec["control"], rec["loss_gap"] = check_steps(
            ctx, weights, checked, gen_state, prog_losses, mu1, params_after, by_ids)
        return rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def readings(ctx, weights, checked, gen_state, losses, mu1, params_after) -> dict:
    """The reference follows the checked steps from the same weights,
    batches and generator; the gaps of the losses, of the first step's
    gradient norms (the program's from Adam's first moment) and of the
    parameters' change after the steps, by the worst leaf."""
    ref = Trainer(ctx.config, weights)
    gen = torch.Generator()
    gen.set_state(gen_state)
    ref_losses, g1, err = [], None, None
    b1 = 0.9
    for batch in checked:
        dev = {k: torch.as_tensor(v).to(ctx.device) for k, v in batch.items()}
        dev = {k: (v.float() if v.is_floating_point() else v.long()) for k, v in dev.items()}
        out = ref.step(dev, ctx.params["p_tf"], gen)
        ref_losses.append(out["loss"])
        if g1 is None:
            g1 = {n: float(torch.linalg.vector_norm(g)) for n, g in out["grads"].items()}
            diff = sum(float(torch.linalg.vector_norm(mu1[n].float() / (1.0 - b1) - g)) ** 2
                       for n, g in out["grads"].items())
            err = math.sqrt(diff) / math.sqrt(sum(v * v for v in g1.values()))
            del out
    prog_g1 = {n: float(torch.linalg.vector_norm(mu1[n])) / (1.0 - b1) for n in g1}
    w0 = {n: weights[n].float() for n in ref.params}
    ref_dp = {n: float(torch.linalg.vector_norm(ref.params[n].detach() - w0[n])) for n in ref.params}
    prog_dp = {n: float(torch.linalg.vector_norm(params_after[n].float() - w0[n]))
               for n in ref.params}
    med = float(np.median(list(g1.values())))
    moved = {n for n in g1 if g1[n] >= 1e-3 * med}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_err": err,
        "grad_gap": leaf_gap(prog_g1, g1),
        "change_gap": leaf_gap(prog_dp, ref_dp, moved),
        "ref_losses": ref_losses,
    }


def check_steps(ctx, weights, checked, gen_state, losses, mu1, params_after, by_ids):
    """The checks, the control's readings in a control run, and the loss
    gap (read, not compared: no control or fault separates it)."""
    limits = ctx.params["limits"]
    got = readings(ctx, weights, checked, gen_state, losses, mu1, params_after)
    res = {k: harness.check(got[k], limits[k]) for k in ("grad_err", "grad_gap", "change_gap")}
    res["rows_mismatch"] = harness.check(sum(rows_mismatch(b, by_ids) for b in checked), 0)
    control = control_readings(ctx, weights, checked, gen_state) if ctx.control else None
    return res, control, got["loss_gap"]


def control_readings(ctx, weights, checked, gen_state) -> dict:
    """The reference in float8 run in the program's place and read as the
    program is read."""
    from portbench.reference.model import fp8

    low = Trainer(ctx.config, weights, q=fp8)
    gen = torch.Generator()
    gen.set_state(gen_state)
    losses, mu1 = [], None
    for batch in checked:
        dev = {k: torch.as_tensor(v).to(ctx.device) for k, v in batch.items()}
        dev = {k: (v.float() if v.is_floating_point() else v.long()) for k, v in dev.items()}
        losses.append(low.step(dev, ctx.params["p_tf"], gen)["loss"])
        if mu1 is None:
            mu1 = {n: v.clone() for n, v in low.mu.items()}
    after = {n: v.detach().clone() for n, v in low.params.items()}
    del low
    got = readings(ctx, weights, checked, gen_state, losses, mu1, after)
    return {k: got[k] for k in ("loss_gap", "grad_err", "grad_gap", "change_gap")}
