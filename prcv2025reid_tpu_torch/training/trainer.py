"""The training orchestrator (counterpart of the JAX package's
``training/trainer.py``; method for method).

Wires: dataset split -> strict P x K pipeline -> model and optimizer state
on the device -> epoch loop with SDM scheduling, health monitors,
per-epoch whitelist eval, best / latest / periodic checkpoints, exact
resume, and CSV histories.  The loop reads device values on the host only
at step 1 and every ``LOG_EVERY`` steps (one stacked fetch of the step's
metrics) and once at the end of each epoch (the metric ring, the skip
counter, the classifier's norm): the train step itself never waits for
the device.

The model holds its weights and the train step updates them in place, so
the embed steps that ``evaluate`` builds (``embed_factory``) read the live
parameters: the trainer evaluates the module it trains.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.data.dataset import analyze_sampling_capability, quick_scan
from prcv2025reid_tpu_torch.data.device_feed import prefetch_to_device
from prcv2025reid_tpu_torch.data.pipeline import HostPipeline, collate
from prcv2025reid_tpu_torch.data.sampler import PKBatchSampler
from prcv2025reid_tpu_torch.data.split import create_split_datasets, verify_split_integrity
from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
from prcv2025reid_tpu_torch.engine import (
    build_model,
    init_train_state,
    make_combo_embed_step,
    make_train_step,
    resolve_device,
)
from prcv2025reid_tpu_torch.evaluation.protocol import (
    GalleryCache,
    checkpoint_cache_tag,
    evaluate_protocol,
)
from prcv2025reid_tpu_torch.params import init_params
from prcv2025reid_tpu_torch.tools.convert_clip import (
    clip_source,
    convert_clip_params,
    load_hf_state_dict,
)
from prcv2025reid_tpu_torch.training.checkpoint import (
    finalize_pending_saves,
    latest_checkpoint_exists,
    restore_checkpoint,
    save_checkpoint,
)
from prcv2025reid_tpu_torch.training.monitors import (
    BatchCountReport,
    CEDiagnostics,
    FeatureNormMonitor,
    MetricsHistory,
    PairCoverageMonitor,
    SpikeDetector,
    batch_composition,
)
from prcv2025reid_tpu_torch.training.param_groups import count_trainable, set_plateau_scale
from prcv2025reid_tpu_torch.training.schedulers import PlateauScheduler, SDMScheduler
from prcv2025reid_tpu_torch.training.train_step import RING_CHANNELS
from prcv2025reid_tpu_torch.utils.distributed import is_main_process

LOG_EVERY = 100  # fetch the step's metrics at this cadence

logger = logging.getLogger(__name__)


class Trainer:
    def __init__(self, config: TrainingConfig, device: Union[str, torch.device] = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        os.makedirs(config.save_dir, exist_ok=True)
        os.makedirs(config.log_dir, exist_ok=True)

        # --- data ---
        self.train_ds, self.val_ds, pid2label = create_split_datasets(config)
        verify_split_integrity(self.train_ds, self.val_ds)
        self.num_classes = len(pid2label)
        report = analyze_sampling_capability(self.train_ds)
        if not report["pairable"]:
            raise RuntimeError(f"no pairable identities — training cannot proceed: {report}")
        logger.info("sampling capability: %s", report)
        scan = quick_scan(self.train_ds)
        logger.info("quick_scan: %s", scan)
        if scan["legacy_names"]:
            logger.warning("legacy modality directory names in data_root: %s — "
                           "normalization did not run", scan["legacy_names"])

        self.tokenizer = build_tokenizer(config.tokenizer_vocab_path, config.text_vocab_size,
                                         config.text_context_length)
        self.sampler = PKBatchSampler(
            self.train_ds, config.num_ids_per_batch, config.instances_per_id,
            allow_id_reuse=config.allow_id_reuse, seed=config.seed,
            steps_per_epoch=config.steps_per_epoch, force_modal_pairs=config.force_modal_pairs,
            sampling_fallback=config.sampling_fallback,
            min_modal_coverage=config.min_modal_coverage)
        # the model's modality dropout is the one in force; the per-sample
        # path stays off so the masks say what the data holds
        self.pipeline = HostPipeline(self.train_ds, self.sampler, self.tokenizer,
                                     num_workers=config.num_workers,
                                     prefetch=config.prefetch_batches, seed=config.seed,
                                     modality_dropout=0.0)

        # --- model, optimizer state and step ---
        # JAX's initial values: zero lora_B and biases, unit scales, BN
        # statistics (0, 1); with clip_weights_path the encoder's CLIP leaves
        # are converted in before the optimizer state is built (a resumed
        # run then restores its checkpoint over them, as JAX's does)
        params = init_params(config, self.num_classes, config.seed, perturb=False)
        if config.clip_weights_path:
            source = clip_source(config)
            params = convert_clip_params(load_hf_state_dict(source), params, seed=config.seed)
            logger.info("loaded CLIP weights from %s (%s)", config.clip_weights_path, source)
        self.model = build_model(config, params, device=self.device)
        steps_per_epoch = len(self.sampler)
        if config.accum_steps > 1:
            logger.info("gradient accumulation: %d x %d = effective batch %d (target %d)",
                        config.batch_size, config.accum_steps,
                        config.batch_size * config.accum_steps, config.target_effective_batch)
        self.state = init_train_state(self.model, config, steps_per_epoch, seed=config.seed + 1)
        self.train_step = make_train_step(self.model, config, steps_per_epoch)
        self._embed_cache: Dict = {}
        logger.info("param groups: %s", count_trainable(
            self.model, config.freeze_backbone, config.freeze_text_backbone))

        # --- host-side state ---
        self.sdm_scheduler = SDMScheduler.from_config(config)
        self.spike_detector = SpikeDetector()
        self.pair_coverage = PairCoverageMonitor(window=config.pair_coverage_window,
                                                 target=config.pair_coverage_target)
        self.ce_diag = CEDiagnostics(self.num_classes)
        self.feat_norm_monitor = FeatureNormMonitor()
        self.batch_counts = BatchCountReport(len(self.sampler))
        self.plateau = (PlateauScheduler.from_config(config)
                        if config.scheduler == "plateau" else None)
        # one event dir per history: tensorboardX names its files by the
        # whole second, so two writers in one dir collide
        tb = config.tensorboard and is_main_process()
        self.train_history = MetricsHistory(
            os.path.join(config.log_dir, "tb", "train") if tb else None, tag_prefix="train/")
        self.eval_history = MetricsHistory(
            os.path.join(config.log_dir, "tb", "eval") if tb else None, tag_prefix="eval/")
        self.start_epoch = 1
        self.best_map = 0.0
        self._crop_relaxed = False

    def _relax_augmentation(self):
        """Crop scale 0.8 -> 0.6; the worker processes hold a pickled copy
        of the dataset, so they are refreshed to see it."""
        self._crop_relaxed = True
        self.train_ds.transform.set_crop_scale_min(0.6)
        self.pipeline.refresh_workers()
        logger.info("augmentation relaxed: crop scale 0.8 -> 0.6")

    # ----- embed steps, one per modality combo -----

    def embed_factory(self, modalities):
        key = tuple(modalities)
        if key not in self._embed_cache:
            self._embed_cache[key] = make_combo_embed_step(self.model, key)
        return self._embed_cache[key]

    # ----- resume -----

    def maybe_resume(self) -> bool:
        if not latest_checkpoint_exists(self.config.save_dir):
            return False
        self.state, host = restore_checkpoint(self.config.save_dir, self.model, self.state,
                                              device=self.device)
        self.start_epoch = host["epoch"] + 1
        self.best_map = host["best_map"]
        self.sdm_scheduler.load_state_dict(host["sdm_scheduler"])
        self.spike_detector.load_state_dict(host["spike_detector"])
        self.sampler.load_state_dict(host["sampler"])
        if self.plateau is not None and host.get("plateau"):
            self.plateau.load_state_dict(host["plateau"])
        if host.get("crop_relaxed"):
            self._relax_augmentation()  # re-apply the relaxed distribution
        # to_csv rewrites whole files: without these the first epoch-end
        # write of a resumed run would erase every earlier row
        self.train_history.load_csv(os.path.join(self.config.log_dir, "train_history.csv"))
        self.eval_history.load_csv(os.path.join(self.config.log_dir, "eval_history.csv"))
        logger.info("resumed from epoch %d (best mAP %.4f)", host["epoch"], self.best_map)
        return True

    def _host_state(self, epoch: int) -> Dict:
        return {
            "epoch": epoch,
            "best_map": self.best_map,
            "sdm_scheduler": self.sdm_scheduler.state_dict(),
            "spike_detector": self.spike_detector.state_dict(),
            "sampler": self.sampler.state_dict(),
            "plateau": self.plateau.state_dict() if self.plateau is not None else None,
            "crop_relaxed": self._crop_relaxed,
            "num_classes": self.num_classes,
            "config": self.config.to_json(),
        }

    # ----- epoch loop -----

    def _host_batches(self, epoch: int):
        """The pipeline's batches; the first three of the first three epochs
        log their composition from the host arrays, before the copy to the
        device, so the loop reads nothing back for it."""
        for i, batch in enumerate(self.pipeline):
            if epoch <= 3 and i < 3:
                comp = batch_composition(batch.get("pids", batch["labels"]),
                                         batch["image_mask"], batch["text_mask"])
                logger.info(
                    "[batch-composition] epoch=%d batch=%d: %d ids, %.1f inst/id (K-1 pos "
                    "~%.1f), vis+nonvis=%d, vis-only=%d, nonvis-only=%d", epoch, i,
                    comp["num_ids"], comp["avg_instances_per_id"],
                    comp["avg_instances_per_id"] - 1, comp["both"], comp["vis_only"],
                    comp["nonvis_only"])
            yield batch

    def train_epoch(self, epoch: int, train_metrics_prev: Optional[Dict] = None) -> Dict:
        cfg = self.config
        self.pipeline.set_epoch(epoch)
        # the single authority for the live (weight, tau)
        sdm_weight, sdm_tau = self.sdm_scheduler.get_parameters(epoch, train_metrics_prev or {})
        enable_moddrop = epoch > cfg.modality_dropout_warmup_epochs

        sums: Dict[str, float] = {}
        n_steps = 0
        n_logged = 0
        skipped_before = int(self.state.skipped_total)
        step_before = self.state.step
        t0 = time.time()

        def _log_metrics(metrics):
            nonlocal n_logged
            # one host read for all of the step's metrics
            values = torch.stack([v.float() for v in metrics.values()]).tolist()
            for k, v in zip(metrics, values):
                sums[k] = sums.get(k, 0.0) + v
            n_logged += 1

        last = None
        for batch in prefetch_to_device(self._host_batches(epoch), size=cfg.prefetch_batches,
                                        device=self.device):
            self.state, metrics = self.train_step(self.state, batch, sdm_weight, sdm_tau,
                                                  enable_modality_dropout=enable_moddrop)
            n_steps += 1
            last = metrics
            # the loss / top-1 feed at a reduced cadence; every exact
            # monitor reads the metric ring at the epoch's end
            if n_steps % LOG_EVERY == 0 or n_steps == 1:
                _log_metrics(metrics)
                last = None
        if last is not None:
            _log_metrics(last)

        # --- the epoch-end ring fetch: one read for all n_steps rows ---
        ring = self.state.metric_ring.cpu().numpy()
        take = min(n_steps, ring.shape[0])
        idxs = (step_before + np.arange(n_steps))[-take:] % ring.shape[0]
        rows = ring[idxs]  # [take, len(RING_CHANNELS)]
        ce_random_steps = 0
        feat_warn = None
        for row in rows:
            self.spike_detector.update(float(row[0]))
            self.pair_coverage.update_value(float(row[3]))
            if np.isfinite(row[1]) and self.ce_diag.is_random(float(row[1])):
                ce_random_steps += 1
            warn = self.feat_norm_monitor.check(float(row[5]), float(row[4]), epoch)
            if warn:
                feat_warn = warn
        if epoch > 2 and len(rows) and ce_random_steps > len(rows) // 2:
            logger.warning("CE near random baseline ln(%d)=%.3f on %d/%d steps — check "
                           "labels/pairing", self.num_classes, self.ce_diag.random_baseline,
                           ce_random_steps, len(rows))
        if feat_warn:
            logger.warning(feat_warn)
        finite = np.isfinite(rows[:, 0]) if len(rows) else np.zeros(0, bool)
        ring_means = (rows[finite].mean(axis=0) if finite.any()
                      else np.zeros(len(RING_CHANNELS), np.float32))

        avg = {k: v / max(1, n_logged) for k, v in sums.items()}
        elapsed = time.time() - t0
        # the classifier's |W|, read once an epoch, never in the loop
        cls_kernel = self.model.bn_neck.classifier.kernel.detach().cpu().numpy()
        out = {
            "epoch": epoch,
            "steps": n_steps,
            "steps_per_sec": n_steps / max(elapsed, 1e-9),
            "sdm_weight": sdm_weight,
            "sdm_tau": sdm_tau,
            "stability_score": self.spike_detector.stability_score,
            "pair_coverage_mavg": self.pair_coverage.moving_average,
            "head_weight_norm": float(np.linalg.norm(cls_kernel)),
            "skipped_steps": int(self.state.skipped_total) - skipped_before,
            # exact per-epoch loss means over EVERY step (the metric ring)
            "total_loss": float(ring_means[0]),
            "ce_loss": float(ring_means[1]),
            "sdm_loss": float(ring_means[2]),
            **{k: avg.get(k, 0.0) for k in ("train_top1", "grad_norm")},
        }
        # the SDM anomaly response
        if out["sdm_loss"] > 5.0 or out["sdm_loss"] < 0.0:
            self.sdm_scheduler.decrease_weight("sdm loss anomaly")
        return out

    def _gallery_cache(self) -> GalleryCache:
        """A cache tag fingerprinted by the parameters and the compute path,
        so features are reused only for the same weights on the same path
        (the final full-ratio eval after the last epoch's eval hits it)."""
        tag = checkpoint_cache_tag(self.model, self.config.eval_cache_tag,
                                   step=self.state.step, config=self.config)
        return GalleryCache(self.config.eval_cache_dir, tag)

    def evaluate(self, epoch: Optional[int] = None, sample_ratio: Optional[float] = None) -> Dict:
        cfg = self.config
        result = evaluate_protocol(
            None, self.val_ds, self.tokenizer, batch_size=cfg.eval_batch_size,
            include_patterns=cfg.eval_include_patterns, cache=self._gallery_cache(),
            sample_ratio=sample_ratio if sample_ratio is not None else cfg.eval_sample_ratio,
            seed=cfg.seed, embed_factory=self.embed_factory, device=self.device)
        if epoch is not None:
            logger.info("[EVAL] epoch=%d mAP(avg2)=%.4f single=%.4f quad=%.4f", epoch,
                        result["map_avg2"], result["map_single"], result["map_quad"])
        return result

    def smoke_test(self):
        """One real batch through the model before the epoch loop; abort on
        failure.  The batch is built directly (sampler draw + collate):
        iterating the pipeline would spend a whole epoch of the sampler's
        stream, so the sampler's state is restored after the draw and epoch
        1 sees the stream it would see without the smoke test."""
        snap = self.sampler.state_dict()
        indices = self.sampler.sample_batch()
        self.sampler.load_state_dict(snap)
        rng = np.random.default_rng(0)
        samples = [self.train_ds.get_sample(i, rng, modality_dropout=0.0) for i in indices]
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in collate(samples, self.tokenizer).items()}
        with torch.inference_mode():
            out, _ = self.model(batch["images"], batch["image_mask"], batch["text_tokens"],
                                batch["text_mask"], train=False)
        if not bool(torch.isfinite(out["logits"]).all()):
            raise RuntimeError("forward smoke test produced non-finite logits")
        logger.info("forward smoke test OK: logits %s, bn_features %s",
                    tuple(out["logits"].shape), tuple(out["bn_features"].shape))

    def fit(self) -> Dict:
        resumed = self.maybe_resume()
        if not resumed:
            self.smoke_test()
        try:
            return self._fit_loop()
        finally:
            # an async save may still be in flight (its sidecar lands only
            # on commit): make the last checkpoint durable even on error;
            # the decode workers stop (a later epoch starts new ones)
            self.pipeline.close()
            finalize_pending_saves()

    def _fit_loop(self) -> Dict:
        cfg = self.config
        block = not cfg.async_checkpoint
        # a resumed run feeds the SDM scheduler the last finished epoch's
        # metrics (the reloaded history's last row), as the uninterrupted
        # run does; JAX passes none here, so its resumed epoch takes the
        # scheduler's held values instead of the schedule
        train_metrics: Optional[Dict] = (
            self.train_history.rows[-1] if self.start_epoch > 1 and self.train_history.rows
            else None)
        for epoch in range(self.start_epoch, cfg.num_epochs + 1):
            train_metrics = self.train_epoch(epoch, train_metrics)
            self.batch_counts.record_epoch(train_metrics["steps"])
            self.train_history.append(train_metrics)
            logger.info("epoch %d: %s", epoch, train_metrics)

            # the augmentation relaxes AFTER epoch 5, on epoch 5's own
            # stability score; the flag persists through checkpoints
            if (epoch == 5 and not self._crop_relaxed
                    and train_metrics.get("stability_score", 0.0) > 0.8):
                self._relax_augmentation()

            if cfg.do_eval and epoch % cfg.eval_every_n_epoch == 0:
                eval_metrics = self.evaluate(epoch)
                row = {k: v for k, v in eval_metrics.items() if k != "detail"}
                row["epoch"] = epoch
                self.eval_history.append(row)
                if eval_metrics["map_avg2"] > self.best_map:
                    self.best_map = eval_metrics["map_avg2"]
                    best_abs = os.path.abspath(cfg.best_model_path
                                               or os.path.join(cfg.save_dir, "best"))
                    save_checkpoint(os.path.dirname(best_abs), self.model, self.state,
                                    self._host_state(epoch), name=os.path.basename(best_abs),
                                    block=block)
                    logger.info("new best mAP %.4f — checkpoint saved to %s", self.best_map,
                                best_abs)
                # the SDM weight's escalation gate
                if self.sdm_scheduler.can_increase_weight(epoch, train_metrics, eval_metrics):
                    self.sdm_scheduler.increase_weight()
                # plateau LR drops on the eval mAP
                if self.plateau is not None:
                    scale = self.plateau.step(eval_metrics["map_avg2"])
                    set_plateau_scale(self.state.opt_state, scale)
                    if scale < 1.0:
                        logger.info("plateau LR scale: %.5f", scale)

            save_checkpoint(cfg.save_dir, self.model, self.state, self._host_state(epoch),
                            block=block)
            if epoch % cfg.save_freq == 0:
                save_checkpoint(cfg.save_dir, self.model, self.state, self._host_state(epoch),
                                name=f"epoch_{epoch}", block=block)
            if is_main_process():
                self.train_history.to_csv(os.path.join(cfg.log_dir, "train_history.csv"))
                self.eval_history.to_csv(os.path.join(cfg.log_dir, "eval_history.csv"))

        # the sampler-stability report
        batch_report = self.batch_counts.summary()
        if batch_report:
            logger.info(
                "batch-count report: estimate=%d actual avg=%.1f range=[%d, %d] "
                "accuracy=%.1f%% cv=%.3f (%s)", batch_report["estimated_batches"],
                batch_report["avg_batches"], batch_report["min_batches"],
                batch_report["max_batches"], 100 * batch_report["estimate_accuracy"],
                batch_report["batch_cv"], "stable" if batch_report["stable"] else "fluctuating")
        # the final full-ratio eval
        final = self.evaluate(cfg.num_epochs, sample_ratio=1.0) if cfg.do_eval else {}
        return {
            "best_map": self.best_map,
            "batch_report": batch_report,
            "final": {k: v for k, v in final.items() if k != "detail"},
        }
