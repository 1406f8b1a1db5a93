"""Training orchestration (``transformertts_tpu/train/trainer.py``).

Per-epoch teacher-forcing schedule, the bucketed train loop (batches from
``prefetch(loader.epoch(e))``, one optimizer step of ``make_train_step`` per
batch), teacher-forced validation with the plot suite, free-running
validation through the KV-cached decode, early stopping (patience on
val_loss, ref train.py:31-36), checkpoints with resume and best-metric
retention, throughput in audio-seconds per second, and optional
``torch.profiler`` traces.

Data, tensor and sequence parallelism (``runtime.mesh_data`` /
``mesh_model``, ``runtime.shard_sequence``) run one process per device over
``torch.distributed`` (``parallel/mesh.py``; the caller initialises the
process group, as ``cli train --distributed`` does).  The mesh must use
every process and ``training.batch_size``, the global batch as in the JAX
package, must split over its data ranks: each loads ``batch_size /
n_data`` rows of every batch (``BucketedLoader``'s process shards), the
ranks of one model group the same rows.  Only rank 0 logs, plots and
writes ``history.json``; checkpoints hold the whole tensors (gathered,
written by rank 0).  Validation runs on rank 0 on ``eval_model``, which
holds the gathered ``eval_params`` (its free-running decode is the
one-device decode-step kernel), and the metrics go to every rank, so
every rank takes the same decisions.

Randomness: every dropout mask and scheduled-sampling bit of epoch ``e``
derives from ``torch.Generator().manual_seed(seed + 1000 + e)`` and the
loader shuffles from ``seed + e``, so a resumed epoch draws what the
uninterrupted one drew.

Deviation from the JAX package: on resume, the best-metric incumbent is
recovered from ``history.json`` only when ``checkpoints_best/`` holds a
checkpoint; with it empty the incumbent is inf, so the first validated
epoch fills it.
"""

from __future__ import annotations

import copy
import json
import logging
import statistics
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from transformertts_tpu_torch.config import Config
from transformertts_tpu_torch.data import BucketedLoader, LJSpeechDataset
from transformertts_tpu_torch.data.prefetch import batch_to_device, prefetch
from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.infer.decode import make_decode_fn
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.models.factory import runtime_model_kwargs
from transformertts_tpu_torch.parallel import collectives
from transformertts_tpu_torch.parallel.mesh import gather_tree, make_mesh, shard_batch, shard_state
from transformertts_tpu_torch.train.checkpoint import CheckpointManager
from transformertts_tpu_torch.train.metrics import mcd_dtw, mel_cepstral_distortion
from transformertts_tpu_torch.train.schedules import noam_schedule, teacher_forcing_ratio
from transformertts_tpu_torch.train.train_step import (
    TrainState,
    count_params,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from transformertts_tpu_torch.utils import log_step_info, setup_logger
from transformertts_tpu_torch.utils import plot as plots

# keys of a history row that are wall-clock measurements, not results
TIMING_KEYS = ("audio_s_per_s", "epoch_s", "step_ms_median", "loader_wait_share",
               "loader_wait_first_ms", "val_tf_ms", "val_free_ms", "ckpt_save_ms")


def build_mesh(cfg: Config):
    """The training mesh from ``runtime.mesh_data`` / ``mesh_model`` and the
    world; raises, with the numbers, for a mesh that leaves a process idle,
    a batch that does not split over the data ranks, or sequence
    parallelism without model ranks to split time over."""
    r = cfg.runtime
    mesh = make_mesh(r.mesh_data, r.mesh_model)
    if r.shard_sequence and mesh.n_model == 1:
        raise ValueError("runtime.shard_sequence splits the time axes over the model ranks: "
                         "it needs runtime.mesh_model > 1")
    if cfg.training.batch_size % mesh.n_data:
        raise ValueError(f"training.batch_size={cfg.training.batch_size} does not split over "
                         f"{mesh.n_data} data ranks")
    return mesh


class Trainer:
    def __init__(self, cfg: Config, exp_dir: str | Path, resume: bool = True,
                 profile_steps: int = 0, device: str | torch.device | None = None):
        """``device`` None means the GPU (each process's current one)."""
        self.device = resolve_device(device)
        self.mesh = build_mesh(cfg)
        self.rank0 = self.mesh.rank == 0
        self.profile_steps = profile_steps
        self.cfg = cfg
        self.exp_dir = Path(exp_dir)
        self.log = setup_logger(str(self.exp_dir / "train.log") if self.rank0 else None)
        if not self.rank0:
            self.log.setLevel(logging.WARNING)
        if self.mesh.size > 1:
            self.log.info("mesh: %s over %d processes%s", self.mesh.shape, self.mesh.size,
                          " + sequence-parallel" if cfg.runtime.shard_sequence else "")
        self.model = TransformerTTS(
            cfg.model, generator=torch.Generator().manual_seed(cfg.training.seed),
            **runtime_model_kwargs(cfg, self.device))
        # validation's model: eval_params and the BatchNorm statistics (whole
        # tensors), copied in before every validation
        self.eval_model = copy.deepcopy(self.model)
        self.plots_on = self.rank0 and plots.available()
        if self.rank0 and not self.plots_on:
            self.log.info("matplotlib is not installed: plots are skipped")

        self._build_data()
        self._build_state(resume)
        self.train_step_ss = make_train_step(
            self.model, cfg, scheduled_sampling=True, return_mixed_inputs=True)
        self.train_step_tf = make_train_step(self.model, cfg, scheduled_sampling=False)
        self.eval_step = make_eval_step(self.eval_model, cfg, with_outputs=True)
        self.eval_state = TrainState(step=0, model=self.eval_model, opt_state={})
        self.decode = make_decode_fn(self.eval_model, cfg, device=self.device)
        self.audio_sec_per_frame = cfg.audio.hop_length / cfg.audio.sample_rate
        self.last_free_decode: dict | None = None  # inputs and outputs of the last one

    def _build_data(self):
        cfg = self.cfg
        train_ds = LJSpeechDataset(cfg.path.preprocessed, "train")
        val_ds = LJSpeechDataset(cfg.path.preprocessed, "val")
        common = dict(
            phoneme_buckets=cfg.runtime.phoneme_buckets,
            mel_buckets=cfg.runtime.mel_buckets,
            n_mels=cfg.model.n_mels,
            seed=cfg.training.seed,
            n_threads=cfg.training.num_workers,
        )
        # each data rank loads its rows of every global batch, on its own
        # reader threads; validation runs whole on rank 0
        self.train_loader = BucketedLoader(
            train_ds, cfg.training.batch_size // self.mesh.n_data,
            grad_acc_steps=cfg.training.grad_acc_steps, shuffle=True, drop_last=True,
            process_index=self.mesh.data_rank, process_count=self.mesh.n_data, **common)
        self.val_loader = BucketedLoader(
            val_ds, cfg.training.batch_size, grad_acc_steps=1,
            shuffle=False, drop_last=False, **common)
        n_batches = self.train_loader.batches_per_epoch()
        self.log.info("data: %d train / %d val items, %d train batches/epoch; reader %s "
                      "(train) / %s (val), %d threads", len(train_ds), len(val_ds), n_batches,
                      self.train_loader.reader, self.val_loader.reader,
                      cfg.training.num_workers)
        if n_batches == 0:
            raise ValueError(
                f"no full training batch of {cfg.training.batch_size} x "
                f"{cfg.training.grad_acc_steps} in any (phoneme, mel) bucket of "
                f"{cfg.path.preprocessed}")

    def _build_state(self, resume: bool):
        cfg = self.cfg
        state = create_train_state(self.model, cfg)
        self.ckpt = CheckpointManager(self.exp_dir / "checkpoints")
        self.ckpt_best = (
            CheckpointManager(self.exp_dir / "checkpoints_best", max_to_keep=1)
            if cfg.training.keep_best_metric else None
        )
        self.start_epoch = 0
        if resume:
            # adopt_ema=False: resumed EMA-off training must not adopt a disk
            # EMA into its state (it would change the checkpoint layout)
            restored, epoch = self.ckpt.restore(state, adopt_ema=False)
            if restored is not None:
                state, self.start_epoch = restored, epoch
        if self.mesh.size > 1:
            state = shard_state(state, self.mesh, cfg.runtime.shard_sequence)
        self.state = state
        self.log.info("model parameters: %.2fM", count_params(self.eval_model) / 1e6)
        self.noam = noam_schedule(cfg.model.d_model, cfg.training.warmup_steps)
        # guided-attention annealing (loss.guided_attn_anneal_at_diag): the
        # epoch the linear decay began, or None while the trigger hasn't
        # fired.  Recovered from history.json on resume.
        self.ga_anneal_start: int | None = None
        self.prev_history: list[dict] = []
        hist_path = self.exp_dir / "history.json"
        if self.start_epoch > 0 and hist_path.exists():
            with open(hist_path) as f:
                self.prev_history = [
                    h for h in json.load(f) if h.get("epoch", 1 << 30) < self.start_epoch
                ]
            self.ga_anneal_start = self._recover_anneal_start(self.prev_history, cfg.loss)

    # ------------------------------------------------------------------ train

    def train_epoch(self, epoch: int, profile_steps: int = 0) -> dict:
        """One epoch; ``profile_steps > 0`` writes a ``torch.profiler`` trace
        of that many steps (after the first) into <exp_dir>/profile."""
        cfg = self.cfg
        t = cfg.training
        p_tf = teacher_forcing_ratio(epoch, t.num_epochs, t.teacher_forcing_mode,
                                     t.teacher_forcing_warmup_epochs)
        use_ss = p_tf < 1.0
        step_fn = self.train_step_ss if use_ss else self.train_step_tf
        gen = torch.Generator().manual_seed(t.seed + 1000 + epoch)
        ga_w = self._guided_weight(epoch)

        step_metrics, step_s, waits = [], [], []  # waits: the epoch's data.wait spans
        audio_seconds = 0.0
        prof = None
        t_start = time.perf_counter()
        batches = prefetch(self.train_loader.epoch(epoch), waits=waits)
        while True:
            batch = next(batches, None)  # blocked here = the loader holds the step back
            t1 = time.perf_counter()
            if batch is None:
                break
            if profile_steps and len(step_s) == 1 and prof is None and self.rank0:
                prof = self._start_profile()
            audio_seconds += float(batch["melspec_lens"].sum()) * self.audio_sec_per_frame
            if self.model.layout.seq:  # this rank's time slice of its rows
                batch = shard_batch(batch, self.mesh, shard_sequence=True, rows=False)
            dev_batch = batch_to_device(batch, self.device)
            if use_ss:
                self.state, metrics, mixed = step_fn(self.state, dev_batch, p_tf, gen, ga_w)
            else:
                self.state, metrics = step_fn(self.state, dev_batch, p_tf, gen, ga_w)
            # the step read its loss and norm back (the non-finite guard), so
            # the host clock here has waited for the device
            step_s.append(time.perf_counter() - t1)
            if prof is not None and len(step_s) >= 1 + profile_steps:
                self._stop_profile(prof)
                prof = None
            # metrics stay on the device and are read back at the epoch's end
            # (and for the log line every log_interval steps, as in the JAX package)
            step_metrics.append(metrics)
            if len(step_s) % t.log_interval == 0:
                step_now = self.state.step
                log_step_info(self.log, epoch, step_now,
                              {k: float(v) for k, v in metrics.items()},
                              float(self.noam(step_now)),
                              audio_seconds / (time.perf_counter() - t_start))
                # train-time scheduled-sampling dump from the ACTUAL mixed
                # batch (ref: lightning_module.py:82)
                if use_ss and self.plots_on:
                    plots.plot_mels_scheduled(
                        mixed.float().cpu().numpy(), batch["melspec"][0],
                        batch["melspec_lens"][0],
                        self.exp_dir / "mels_scheduled"
                        / f"epoch_{epoch:04d}_step_{step_now:06d}.png")
        if prof is not None:  # epoch shorter than the profile window
            self._stop_profile(prof)

        totals: dict[str, float] = {}
        if step_metrics:
            names = list(step_metrics[0])
            fetched = torch.stack([torch.stack([m[k].float() for k in names])
                                   for m in step_metrics]).tolist()  # the one readback
            for row in fetched:
                for name, val in zip(names, row):
                    totals[name] = totals.get(name, 0.0) + val
        n_steps = len(step_metrics)
        if self.mesh.n_data > 1:  # every data rank's rows
            audio_seconds = float(collectives.all_reduce(
                torch.tensor(audio_seconds, dtype=torch.float64, device=self.device),
                self.mesh.data_group))
        skipped = totals.get("skipped", 0.0)
        if skipped:
            self.log.warning("epoch %d: %d non-finite steps skipped (failure guard)",
                             epoch, int(skipped))
            if skipped > 0.5 * max(n_steps, 1):
                raise RuntimeError(
                    f"over half of epoch {epoch}'s steps were non-finite — aborting")
        elapsed = time.perf_counter() - t_start
        avg = {name: v / max(n_steps, 1) for name, v in totals.items()}
        avg["audio_s_per_s"] = audio_seconds / elapsed
        avg["epoch_s"] = elapsed
        avg["step_ms_median"] = 1e3 * statistics.median(step_s) if step_s else float("nan")
        # the first batch overlaps no step; the later ones show whether the
        # loader keeps up with the steps
        avg["loader_wait_share"] = sum(s.ns for s in waits) * 1e-9 / elapsed
        avg["loader_wait_first_ms"] = waits[0].ns * 1e-6
        avg["p_tf"] = p_tf
        if ga_w is not None:
            avg["ga_w"] = float(ga_w)
            # exact trigger epoch for resume recovery (ga_w alone is
            # ambiguous while the decay fraction is still 0)
            avg["ga_anneal_start"] = self.ga_anneal_start
        self.log.info(
            "epoch %d done: loss %.4f | p_tf %.3f | %.1f audio-s/s | median step %.1f ms | "
            "loader wait %.1f %%", epoch, avg.get("total", float("nan")), p_tf,
            avg["audio_s_per_s"], avg["step_ms_median"], 100 * avg["loader_wait_share"])
        return avg

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = self.exp_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"trace_step_{self.state.step:06d}.json"))

    @staticmethod
    def _recover_anneal_start(prev_history: list[dict], loss_cfg) -> int | None:
        """Recover the anneal trigger epoch from a resumed history: the
        explicit ``ga_anneal_start`` record, else the inversion of the
        linear decay from the first row whose ``ga_w`` fell below the base."""
        base = loss_cfg.guided_attn_weight
        for h in prev_history:
            if h.get("ga_anneal_start") is not None:
                return int(h["ga_anneal_start"])
            if "ga_w" in h and h["ga_w"] < base:
                frac = 1.0 - h["ga_w"] / base
                return int(round(h["epoch"] - frac * loss_cfg.guided_attn_anneal_epochs))
        return None

    def _guided_weight(self, epoch: int) -> float | None:
        """Per-epoch guided-attention weight under diagonality-triggered
        annealing; None when annealing is off (static cfg weight applies)."""
        loss_cfg = self.cfg.loss
        if loss_cfg.guided_attn_anneal_at_diag <= 0.0 or loss_cfg.guided_attn_weight <= 0.0:
            return None
        if self.ga_anneal_start is None:
            return loss_cfg.guided_attn_weight
        frac = (epoch - self.ga_anneal_start) / max(loss_cfg.guided_attn_anneal_epochs, 1)
        return loss_cfg.guided_attn_weight * max(1.0 - frac, 0.0)

    # ------------------------------------------------------------------- val

    def validate(self, epoch: int) -> tuple[float, dict]:
        """Teacher-forced and free-running validation on ``eval_model``; on
        a mesh rank 0 validates and every rank returns its numbers."""
        self._sync_eval_model()
        result = self._validate(epoch) if self.rank0 else None
        if self.mesh.size > 1:
            box = [result]
            dist.broadcast_object_list(box, src=self.mesh.ranks[0], group=self.mesh.group)
            result = box[0]
        return result

    def _validate(self, epoch: int) -> tuple[float, dict]:
        t0 = time.perf_counter()
        per_batch, first = [], None
        for batch in self.val_loader.epoch(0):
            micro = {name: arr[0] for name, arr in batch.items()}
            metrics, out = self.eval_step(self.eval_state, micro)
            per_batch.append(metrics)
            if first is None:
                first = (micro, out)
        totals: dict[str, float] = {}
        if per_batch:
            names = list(per_batch[0])
            for row in torch.stack([torch.stack([m[k].float() for k in names])
                                    for m in per_batch]).tolist():
                for name, val in zip(names, row):
                    totals[name] = totals.get(name, 0.0) + val
        avg = {name: v / max(len(per_batch), 1) for name, v in totals.items()}
        avg["tf_ms"] = 1e3 * (time.perf_counter() - t0)
        if first is not None and self.plots_on:
            self._plot_validation(epoch, *first)
        avg.update(self._free_running_eval(epoch))
        self.log.info(
            "epoch %d val: loss %.4f | mel_l1 %.4f | diagonality %.3f | "
            "free mel_l1 %.4f mcd %.2f mcd_dtw %.2f len %.2f",
            epoch, avg.get("total", float("nan")), avg.get("mel_l1", float("nan")),
            avg.get("diagonality", float("nan")),
            avg.get("free_mel_l1", float("nan")), avg.get("free_mcd", float("nan")),
            avg.get("free_mcd_dtw", float("nan")),
            avg.get("free_len_ratio", float("nan")),
        )
        return avg.get("total", float("inf")), avg

    def _plot_validation(self, epoch: int, batch: dict, out: dict):
        e = self.exp_dir
        post = out["post_melspec"].cpu().numpy()
        align = out["alignments"].cpu().numpy()
        plots.plot_mels_batch(post, batch["melspec"], batch["melspec_lens"],
                              e / "mels_batch" / f"epoch_{epoch:04d}.png")
        plots.plot_alignments_batch(align, batch["melspec_lens"], batch["phoneme_lens"],
                                    e / "align_batch" / f"epoch_{epoch:04d}.png")
        plots.plot_alignment_single(align, batch["melspec_lens"][0], batch["phoneme_lens"][0],
                                    e / "align_single" / f"epoch_{epoch:04d}.png")

    def _sync_eval_model(self) -> None:
        """Copy the state's ``eval_params`` (the EMA copy when one is kept)
        and the BatchNorm statistics, whole (gathered over the model ranks:
        every rank calls), into ``eval_model``; the decode repacks its
        kernel weights because their versions changed."""
        # the BatchNorm statistics are whole on every rank; the parameters are gathered
        whole = {**self.model.state_dict(), **gather_tree(self.state.eval_params, self.mesh)}
        with torch.no_grad():
            self.eval_model.load_state_dict(whole, strict=True)

    def _free_running_eval(self, epoch: int, n_samples: int = 4) -> dict:
        """Free-running decode of the first validation items: plot one (ref:
        lightning_module.py:146-157) and return autoregressive quality
        metrics, the train/inference-mismatch signal the teacher-forced loss
        cannot see."""
        ds = self.val_loader.ds
        if len(ds) == 0:
            return {}
        n = min(n_samples, len(ds))
        items = [ds[i] for i in range(n)]
        t_phon = self.cfg.runtime.phoneme_buckets[-1]
        phoneme = np.zeros((n, t_phon), np.int32)
        lens = np.zeros((n,), np.int32)
        for i, item in enumerate(items):
            seq = item["sequence"][:t_phon]
            phoneme[i, : len(seq)] = seq
            lens[i] = len(seq)
        t0 = time.perf_counter()
        out = self.decode(phoneme, lens)
        post = out["post_melspec"].cpu().numpy()
        per_row = out["n_frames_per_row"].cpu().numpy()
        free_ms = 1e3 * (time.perf_counter() - t0)
        self.last_free_decode = {"phoneme": phoneme, "phoneme_lens": lens, "out": out}
        n_frames = max(int(out["n_frames"]), 1)
        if self.plots_on:
            plots.plot_mels_single(post[0, :n_frames], items[0]["melspec"],
                                   self.exp_dir / "mels_single" / f"epoch_{epoch:04d}.png")

        # metrics over min(pred_len, true_len) with the per-row stop-vote lengths
        mel_l1, mcd, mcd_d, len_ratio = [], [], [], []
        for i, item in enumerate(items):
            pred_len = max(int(per_row[i]), 1)
            true = item["melspec"]  # (T, n_mels)
            m = min(pred_len, true.shape[0])
            pred = post[i, :m]
            mel_l1.append(float(np.abs(pred - true[:m]).mean()))
            mcd.append(float(mel_cepstral_distortion(
                torch.from_numpy(pred[None]), torch.from_numpy(true[None, :m]),
                torch.tensor([m]))))
            # DTW-aligned MCD over the FULL prediction: free decode has no
            # timing anchor, so the frame-wise number confounds pacing drift
            # with spectral error
            mcd_d.append(mcd_dtw(post[i, :pred_len], true))
            len_ratio.append(pred_len / max(true.shape[0], 1))
        return {
            "free_mel_l1": float(np.mean(mel_l1)),
            "free_mcd": float(np.mean(mcd)),
            "free_mcd_dtw": float(np.mean(mcd_d)),
            "free_len_ratio": float(np.mean(len_ratio)),
            "free_ms": free_ms,
        }

    # ------------------------------------------------------------------- fit

    def fit(self) -> dict:
        cfg = self.cfg
        best_val, patience = float("inf"), 0
        history = list(self.prev_history)  # resumed runs keep earlier epochs
        # best-checkpoint retention (training.keep_best_metric, lower is
        # better): a resumed run recovers the incumbent from history, but only
        # while checkpoints_best/ still holds the checkpoint it stands for
        best_metric_name = cfg.training.keep_best_metric
        best_metric = float("inf")
        if self.ckpt_best is not None and self.ckpt_best.latest_step() is not None:
            best_metric = min(
                (h[best_metric_name] for h in history if best_metric_name in h),
                default=float("inf"))
        if self.ga_anneal_start is not None:
            self.log.info("guided-attn anneal recovered from history: started epoch %d",
                          self.ga_anneal_start)
        for epoch in range(self.start_epoch, cfg.training.num_epochs):
            train_metrics = self.train_epoch(
                epoch, self.profile_steps if epoch == self.start_epoch else 0)
            val_loss, val_metrics = self.validate(epoch)
            thresh = cfg.loss.guided_attn_anneal_at_diag
            if (thresh > 0.0 and self.ga_anneal_start is None
                    and val_metrics.get("diagonality", 0.0) >= thresh):
                # alignment has formed: hand the rest of training to the
                # reference's exact loss via a linear decay of the guided term
                self.ga_anneal_start = epoch + 1
                self.log.info(
                    "val diagonality %.3f >= %.2f at epoch %d: guided-attn weight anneals "
                    "to 0 over epochs %d-%d", val_metrics["diagonality"], thresh, epoch,
                    self.ga_anneal_start,
                    self.ga_anneal_start + cfg.loss.guided_attn_anneal_epochs - 1)
            if "ga_anneal_start" in train_metrics:
                # the trigger fires after train_epoch: make the trigger
                # epoch's own row already carry it for resume recovery
                train_metrics["ga_anneal_start"] = self.ga_anneal_start
            row = {"epoch": epoch, **train_metrics, "val_loss": val_loss,
                   **{f"val_{k}": v for k, v in val_metrics.items() if k != "total"}}
            history.append(row)

            t0 = time.perf_counter()
            self.ckpt.save(self.state.step, self.state, epoch + 1)
            row["ckpt_save_ms"] = 1e3 * (time.perf_counter() - t0)
            if self.rank0:
                with open(self.exp_dir / "history.json", "w") as f:
                    json.dump(history, f, indent=2)
            row_metric = row.get(best_metric_name)
            if self.ckpt_best is not None and row_metric is not None and row_metric < best_metric:
                best_metric = row_metric
                self.ckpt_best.save(self.state.step, self.state, epoch + 1)
                self.log.info("new best %s %.4f at epoch %d -> checkpoints_best/",
                              best_metric_name, row_metric, epoch)

            if val_loss < best_val:
                best_val, patience = val_loss, 0
            else:
                patience += 1
                if patience >= cfg.training.max_patience:  # ref: train.py:31-36
                    self.log.info("early stopping at epoch %d (patience %d)", epoch, patience)
                    break
        # "epochs" counts epochs trained by THIS call; history also carries
        # the resumed epochs so the anneal trigger survives restarts
        out = {"best_val": best_val, "epochs": len(history) - len(self.prev_history)}
        if self.ckpt_best is not None and best_metric != float("inf"):
            out["best_" + best_metric_name] = best_metric
        return out
