"""Training engine (port of ``pda/train/engine.py``): one :class:`Trainer`
base drives the fit loop (epochs, a validation each epoch, best/latest
checkpoints, the plateau controller, TensorBoard logging, throughput) and
eight subclasses bind the steps of one algorithm each, named after the
reference trainers:

  UNetTrainer, PUNetTrainer, PseudoTrainer, PseudoTrainerPUNet,
  MeanTeacherTrainer, FixMatchTrainer, AdaMTTrainer, AdaMatchTrainer

The engine keeps ``pda``'s semantics in PyTorch's idiom:

  * the model and the state live on ``device``, the card by default;
    without one the constructor raises unless the caller asks for the CPU;
  * the noise comes from one ``torch.Generator`` on the CPU, seeded by
    ``seed`` and handed to every step (a fit on the card and one on the CPU
    see the same noise); the panels draw from a second generator, so
    logging never shifts the training noise;
  * the host never waits on the current step: batches and noise go to the
    card from pinned memory without blocking, and a step's metrics are
    copied back without blocking and read one step later;
  * the step callables (``train_step``, ``val_step``, ``panel_fn``) are
    attributes, set by :meth:`Trainer.initialize` from the subclass's
    factories.

``mixed_precision=True`` is ``pda``'s: a model with a compute ``dtype``
(the PUNet) computes in bf16 with float32 parameters, optimizer and
checkpoints; a model without one (``UNet2d``) stays float32. ``pda``'s device
mesh (data parallelism) is not ported yet: passing one raises.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from . import steps as steps_lib
from .checkpoint import (BEST, LATEST, checkpoint_dir, checkpoint_exists, load_checkpoint,
                         load_params, restore_state, save_checkpoint)
from .logging import (AdaMatchLogger, AdaMTLogger, FixMatchLogger, MeanTeacherLogger,
                      PseudoLogger, PUNetLogger, TrainLogger, _normalize, make_grid)
from .optim import ReduceLROnPlateau, adam
from .profiling import Throughput
from .state import TrainState, create_train_state

#: the panel generator's seed is ``seed`` plus this (``pda``'s panel-local fold)
PANEL_SEED_FOLD = 0x9A7E15


class _HostCopy:
    """Device tensors copied to the host without blocking the host;
    :meth:`result` waits for these copies only."""

    def __init__(self, tensors: dict):
        self._tensors = {k: v.detach().to("cpu", non_blocking=True) for k, v in tensors.items()}
        self._event = None
        if any(v.is_cuda for v in tensors.values()):
            self._event = torch.cuda.Event()
            self._event.record()

    def result(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        return self._tensors


class Trainer:
    """The fit/validate/checkpoint engine."""

    #: subclasses with an EMA teacher set this
    with_teacher = False
    #: whether the steps draw noise (the UNet steps draw none)
    stochastic = True
    #: the TensorBoard image tags this trainer writes
    image_tags: tuple = ()
    #: logger class made for ``logger=True``
    default_logger_cls = TrainLogger

    def __init__(self, name: str, model: torch.nn.Module, train_loader, val_loader, *,
                 learning_rate: float = 1e-5, optimizer: Optional[torch.optim.Optimizer] = None,
                 lr_scheduler: Optional[ReduceLROnPlateau] = None, device="cuda", mesh=None,
                 save_root: Optional[str] = None, logger=True, log_image_interval: int = 100,
                 mixed_precision: bool = False, seed: int = 0):
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: data parallelism is not ported yet (ROADMAP §1, M11); the port "
                "trains on one device")
        # mixed_precision=True (the reference's AMP flag) is pda's bf16 compute:
        # the model's dtype (where it has one) becomes bf16, in place, its
        # parameters, the optimizer and the checkpoints stay float32, and the
        # loss heads take float32 logits and latent statistics (pda/train/engine.py)
        if mixed_precision and hasattr(model, "dtype"):
            model.dtype = torch.bfloat16
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: no CUDA card (torch.cuda.is_available() "
                               "is False); pass device='cpu' to train on the CPU")
        self.name = name
        self.model = model
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.learning_rate = learning_rate
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.save_root = save_root
        self.ckpt_dir = checkpoint_dir(name, save_root)
        # True/False, a TrainLogger class (the reference passes the class) or an instance
        if isinstance(logger, type) and issubclass(logger, TrainLogger):
            self.logger = logger(name, save_root, log_image_interval)
        elif isinstance(logger, TrainLogger):
            self.logger = logger
        else:
            self.logger = (self.default_logger_cls(name, save_root, log_image_interval)
                           if logger else None)
        self.seed = seed
        self.generator = torch.Generator().manual_seed(seed)
        self.panel_generator = torch.Generator().manual_seed(seed + PANEL_SEED_FOLD)

        self._iteration = 0
        self._best_metric = float("inf")
        self._train_time = 0.0
        self.state: Optional[TrainState] = None
        self.train_step: Optional[Callable] = None
        self.val_step: Optional[Callable] = None
        self.panel_fn: Optional[Callable] = None
        self._pending_panels = None
        #: (iteration, scalars) of every train step and every validation
        self.history: list = []
        self.val_history: list = []
        #: host seconds by part of the loop: loader, copy (to the device),
        #: step (its launch), fetch (waiting for the previous step's
        #: metrics), panels, validation (its panels and copies included),
        #: checkpoint; each also a ``torch.profiler`` range ``engine/<part>``
        self.timings: collections.Counter = collections.Counter()

    # -- subclass hooks ------------------------------------------------------

    def make_train_step(self) -> Callable:
        raise NotImplementedError

    def make_val_step(self) -> Callable:
        raise NotImplementedError

    def make_panel_fn(self) -> Optional[Callable]:
        """``panels(model, teacher, *batch, ...) -> {tag: tensor}`` for this
        trainer's image panels, or None."""
        return None

    def panel_batch(self, batch):
        """The part of ``batch`` the panels take."""
        return batch

    def assemble_panels(self, raw: dict) -> dict:
        """Host-side finishing of the panel tensors (grids)."""
        return {k: np.asarray(v, np.float32) for k, v in raw.items()}

    def train_batches(self) -> Iterable[Sequence[np.ndarray]]:
        return iter(self.train_loader)

    def val_batches(self) -> Iterable[Sequence[np.ndarray]]:
        return iter(self.val_loader)

    def _post_initialize(self):
        """Warm starts of the self-training trainers."""

    # -- set-up ---------------------------------------------------------------

    def _example_batch(self):
        """One batch, drawn as ``pda`` draws it to initialize its parameters
        (so the loaders' epochs advance alike), and the empty-loader error."""
        try:
            return next(iter(self.train_loader))
        except StopIteration:
            raise RuntimeError("train loader yielded zero batches — the dataset is empty "
                               "(n_samples too small for the sample count, or no matching "
                               "files)") from None

    @property
    def _noise(self) -> dict:
        return {"generator": self.generator} if self.stochastic else {}

    @property
    def _panel_noise(self) -> dict:
        return {"generator": self.panel_generator} if self.stochastic else {}

    def initialize(self):
        if self.state is not None:
            return
        self._example_batch()
        self.model.to(self.device)
        optimizer = (self.optimizer if self.optimizer is not None
                     else adam(self.model.parameters(), self.learning_rate))
        self.state = create_train_state(self.model, optimizer, with_teacher=self.with_teacher)
        self.train_step = self.make_train_step()
        self.val_step = self.make_val_step()
        self.panel_fn = self.make_panel_fn() if self.logger is not None else None
        self._post_initialize()

    def _put(self, batch) -> tuple:
        """numpy arrays -> tensors on the device in the model's dtype; to the
        card from pinned memory, without blocking the host."""
        dtype = next(self.state.model.parameters()).dtype
        out = []
        with self._span("copy"):
            for b in batch:
                t = torch.from_numpy(np.ascontiguousarray(b))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out.append(t.to(dtype))
        return tuple(out)

    # -- panels ---------------------------------------------------------------

    def _start_panels(self, batch) -> _HostCopy:
        """Launch the panels on the first batch element; their tensors come
        back to the host without blocking."""
        with self._span("panels"):
            small = tuple(b[:1] for b in self.panel_batch(batch))
            teacher = self.state.teacher if self.with_teacher else self.state.model
            return _HostCopy(self.panel_fn(self.state.model, teacher, *small, **self._panel_noise))

    def _flush_panels(self):
        if self._pending_panels is not None:
            step_idx, handle = self._pending_panels
            self._pending_panels = None
            with self._span("panels"):
                images = self.assemble_panels({k: v.numpy() for k, v in handle.result().items()})
                self.logger.log_train(step_idx, {}, images)

    # -- fit loop -------------------------------------------------------------

    @contextlib.contextmanager
    def _span(self, name: str):
        """Host seconds of one part of the loop into ``timings[name]``, and a
        ``torch.profiler`` range ``engine/<name>`` for traces."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"engine/{name}"):
            yield
        self.timings[name] += time.perf_counter() - t0

    def _log_train(self, step_idx: int, handle: _HostCopy, with_lr: bool = True):
        with self._span("fetch"):
            scalars = {k: float(v) for k, v in handle.result().items()}
        if with_lr:
            scalars["learning_rate"] = self.state.learning_rate
        self.history.append((step_idx, scalars))
        if self.logger is not None:
            self.logger.log_train(step_idx, scalars)
            self._flush_panels()

    def fit(self, iterations: int, *, load_from_checkpoint: Optional[str] = None,
            overwrite_training: bool = True) -> dict:
        """Train for ``iterations`` steps, validating every epoch (torch_em
        DefaultTrainer.fit). ``overwrite_training=False`` resumes from the
        latest checkpoint if there is one."""
        self.initialize()
        if (load_from_checkpoint is None and not overwrite_training
                and checkpoint_exists(self.ckpt_dir, LATEST)):
            load_from_checkpoint = LATEST
        if load_from_checkpoint is not None:
            self.load_checkpoint(load_from_checkpoint)

        pending = None  # (iteration, metrics on their way to the host), read one step late
        t_start = time.time()
        throughput = Throughput(self.device)
        self.throughput = throughput
        while self._iteration < iterations:
            epoch_start = self._iteration
            batches = iter(self.train_batches())
            try:
                while self._iteration < iterations:
                    with self._span("loader"):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    batch = self._put(batch)
                    with self._span("step"):
                        self.state, metrics = self.train_step(self.state, *batch, **self._noise)
                        handle = _HostCopy(metrics)
                    throughput.update(int(batch[0].shape[0]))
                    if pending is not None:
                        self._log_train(*pending)
                    pending = (self._iteration, handle)
                    # the reference loggers' train panels, every log_image_interval steps
                    if (self.panel_fn is not None
                            and self._iteration % self.logger.log_image_interval == 0):
                        self._pending_panels = (self._iteration, self._start_panels(batch))
                    self._iteration += 1
            finally:
                close = getattr(batches, "close", None)
                if close is not None:
                    close()
            if self._iteration == epoch_start:
                raise RuntimeError("train loader yielded zero batches — the dataset is empty "
                                   "(n_samples too small for the sample count, or no matching "
                                   "files); training would loop forever")
            throughput.stop()
            val_metrics = self.validate()
            throughput.start()
            current = val_metrics.get("metric", val_metrics.get("loss", 0.0))
            if self.lr_scheduler is not None:
                lr = self.state.learning_rate
                new_lr = self.lr_scheduler.step(current, lr)
                if new_lr != lr:
                    self.state.replace_lr(new_lr)
            self._train_time += time.time() - t_start
            t_start = time.time()
            # the best metric is updated before latest is written, so that a
            # resume from latest never restores a stale best
            improved = current < self._best_metric
            if improved:
                self._best_metric = current
            self.save_checkpoint(LATEST, current)
            if improved:
                self.save_checkpoint(BEST, current)

        if pending is not None:
            self._log_train(*pending, with_lr=False)
        if self.logger is not None:
            self._flush_panels()
        throughput.stop()
        return {"iterations": self._iteration, "train_time": self._train_time,
                **throughput.summary()}

    def validate(self) -> dict:
        """Every validation batch; the metrics are summed on the device and
        read once, at the end."""
        self.initialize()
        with self._span("validation"):
            sums: dict = {}
            n = 0
            last_batch = None
            for batch in self.val_batches():
                batch = self._put(batch)
                self.state, metrics = self.val_step(self.state, *batch, **self._noise)
                for k, v in metrics.items():
                    sums[k] = v if k not in sums else sums[k] + v
                n += 1
                last_batch = batch
            avg = {k: float(v) / max(n, 1) for k, v in _HostCopy(sums).result().items()}
            if "dice" in avg:
                print(f"The Average Dice Score for the Current Epoch is {avg['dice']}")
            if self.logger is not None:
                # the reference loggers write panels at every validation, of the last batch
                images = None
                if self.panel_fn is not None and last_batch is not None:
                    images = self.assemble_panels(
                        {k: v.numpy() for k, v in self._start_panels(last_batch).result().items()})
                self.logger.log_validation(self._iteration, avg, images)
            self.val_history.append((self._iteration, avg))
        return avg

    # -- checkpoints ------------------------------------------------------------

    def save_checkpoint(self, which: str, current_metric: float):
        extra = {"generator_state": self.generator.get_state(),
                 "panel_generator_state": self.panel_generator.get_state()}
        if self.lr_scheduler is not None:
            extra["scheduler_state"] = self.lr_scheduler.state_dict()
        with self._span("checkpoint"):
            save_checkpoint(self.ckpt_dir, self.state, which=which,
                            current_metric=current_metric, best_metric=self._best_metric,
                            train_time=self._train_time, extra=extra)

    def load_checkpoint(self, which: str = BEST) -> dict:
        """Restore the state, iteration, best metric, train time, plateau
        state and noise generators of ``<which>.pt``. The file is read to
        the host and copied into the state on its device, so a checkpoint
        written on the card restores on the CPU and the other way round (and
        Adam's step counts stay on the host, as a fresh optimizer keeps them)."""
        self.initialize()
        blob = load_checkpoint(self.ckpt_dir, which=which, map_location="cpu")
        restore_state(self.state, blob)
        self._iteration = int(blob["iteration"])
        self._best_metric = float(blob.get("best_metric", float("inf")))
        self._train_time = float(blob.get("train_time", 0.0))
        if self.lr_scheduler is not None and "scheduler_state" in blob:
            self.lr_scheduler.load_state_dict(blob["scheduler_state"])
        for gen, key in ((self.generator, "generator_state"),
                         (self.panel_generator, "panel_generator_state")):
            if key in blob:
                gen.set_state(blob[key])
        return blob

    def warm_start(self, ckpt_path_or_dir: str, *, into_teacher: bool = False,
                   from_key: str = "model_state"):
        """Load weights from another run's checkpoint (a ``.pt`` file, or a
        checkpoint directory's best) into the student or the teacher."""
        self.initialize()
        weights = load_params(ckpt_path_or_dir, which=BEST, key=from_key)
        (self.state.teacher if into_teacher else self.state.model).load_state_dict(weights)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------


class _SampleGridPanelsMixin:
    """The 16-sample panel as one grid (``make_grid(nrow=4, padding=4)``)."""

    def assemble_panels(self, raw: dict) -> dict:
        raw = dict(raw)
        samples = np.asarray(raw.pop("samples"), np.float32)
        images = {k: np.asarray(v, np.float32) for k, v in raw.items()}
        images["samples"] = make_grid(list(samples), nrow=4, padding=4)
        return images


class UNetTrainer(Trainer):
    """Supervised UNet2d (torch_em's default segmentation trainer)."""

    stochastic = False
    image_tags = ("input", "target", "prediction")

    def make_train_step(self):
        return steps_lib.make_supervised_unet_step()

    def make_val_step(self):
        return steps_lib.make_supervised_unet_val_step()

    def make_panel_fn(self):
        return steps_lib.make_supervised_unet_panels()


class PUNetTrainer(_SampleGridPanelsMixin, Trainer):
    """Supervised source PUNet training."""

    default_logger_cls = PUNetLogger
    image_tags = ("input", "target", "samples")

    def make_train_step(self):
        return steps_lib.make_supervised_punet_step()

    def make_val_step(self):
        return steps_lib.make_punet_val_step()

    def make_panel_fn(self):
        return steps_lib.make_punet_panels()


class PseudoTrainer(Trainer):
    """UNet on fixed pseudo-labels with consensus masking."""

    stochastic = False
    default_logger_cls = PseudoLogger
    image_tags = ("input", "target", "prediction")

    def make_train_step(self):
        return steps_lib.make_pseudo_unet_step()

    def make_val_step(self):
        return steps_lib.make_pseudo_unet_val_step()

    def make_panel_fn(self):
        return steps_lib.make_pseudo_unet_panels()


class PseudoTrainerPUNet(_SampleGridPanelsMixin, Trainer):
    """PUNet on pseudo-labels and consensus read from disk."""

    default_logger_cls = PseudoLogger
    image_tags = ("input", "target", "samples")

    def make_train_step(self):
        return steps_lib.make_pseudo_punet_step()

    def make_val_step(self):
        return steps_lib.make_pseudo_punet_val_step()

    def make_panel_fn(self):
        return steps_lib.make_pseudo_punet_panels()


class MeanTeacherTrainer(Trainer):
    """Separate-training Mean Teacher; ``ckpt_model`` / ``ckpt_teacher``
    warm-start the student / the teacher from a source run's checkpoint
    (its ``model_state``)."""

    with_teacher = True
    default_logger_cls = MeanTeacherLogger
    image_tags = ("input", "aug_inputs_1", "aug_inputs_2", "teacher_predictions",
                  "teacher_consensus", "ground_truth", "model_samples")

    def __init__(self, *args, ckpt_model: Optional[str] = None,
                 ckpt_teacher: Optional[str] = None, momentum: float = 0.999,
                 do_consensus_masking: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.ckpt_model = ckpt_model
        self.ckpt_teacher = ckpt_teacher
        self.momentum = momentum
        self.do_consensus_masking = do_consensus_masking

    def make_train_step(self):
        return steps_lib.make_mean_teacher_step(
            momentum=self.momentum, do_consensus_masking=self.do_consensus_masking)

    def make_val_step(self):
        return steps_lib.make_mean_teacher_val_step(
            do_consensus_masking=self.do_consensus_masking)

    def make_panel_fn(self):
        return steps_lib.make_mean_teacher_panels(do_consensus_masking=self.do_consensus_masking)

    def _post_initialize(self):
        if self.ckpt_model is not None:
            self.warm_start(self.ckpt_model)
        if self.ckpt_teacher is not None:
            self.warm_start(self.ckpt_teacher, into_teacher=True)


class FixMatchTrainer(Trainer):
    """Separate-training FixMatch; ``source_distribution`` ([bg, fg]) turns
    on distribution alignment."""

    default_logger_cls = FixMatchLogger
    image_tags = ("weak-strong-labels-pred",)

    def __init__(self, *args, ckpt_model: Optional[str] = None, source_distribution=None,
                 do_consensus_masking: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.ckpt_model = ckpt_model
        self.source_distribution = source_distribution
        self.do_consensus_masking = do_consensus_masking

    def make_train_step(self):
        return steps_lib.make_fixmatch_step(source_distribution=self.source_distribution,
                                            do_consensus_masking=self.do_consensus_masking)

    def make_val_step(self):
        return steps_lib.make_fixmatch_val_step(do_consensus_masking=self.do_consensus_masking)

    def make_panel_fn(self):
        return steps_lib.make_fixmatch_panels(do_consensus_masking=self.do_consensus_masking)

    def assemble_panels(self, raw: dict) -> dict:
        # one make_grid(nrow=2, padding=8) of [weak, strong, pseudo-labels, prediction]
        grid = make_grid([_normalize(np.asarray(raw["weak_aug"], np.float32)),
                          _normalize(np.asarray(raw["strong_aug"], np.float32)),
                          np.asarray(raw["pseudo_labels"], np.float32),
                          np.asarray(raw["prediction"], np.float32)], nrow=2, padding=8)
        return {"weak-strong-labels-pred": grid}

    def _post_initialize(self):
        if self.ckpt_model is not None:
            self.warm_start(self.ckpt_model)


class _JointTrainer(Trainer):
    """Joint source + target training: the two loaders zipped, each counting
    its own epochs; an epoch is the shorter one."""

    def __init__(self, name, model, source_train_loader, target_train_loader, val_loader,
                 **kwargs):
        train_loader = (source_train_loader
                        if len(source_train_loader) < len(target_train_loader)
                        else target_train_loader)
        super().__init__(name, model, train_loader, val_loader, **kwargs)
        self.source_train_loader = source_train_loader
        self.target_train_loader = target_train_loader

    def train_batches(self):
        for (xs, ys), (xt, xt1, xt2, yt) in zip(self.source_train_loader,
                                                 self.target_train_loader):
            yield (xs, ys, xt, xt1, xt2, yt)

    def _example_batch(self):
        try:
            return next(self.train_batches())
        except StopIteration:
            raise RuntimeError("joint train stream yielded zero batches — one of the "
                               "source/target loaders is empty (n_samples too small for the "
                               "sample count, or no matching files)") from None

    def panel_batch(self, batch):
        # the target half of a train batch; a validation batch is the target's already
        return batch[2:] if len(batch) == 6 else batch


class AdaMTTrainer(_JointTrainer):
    """Joint Mean Teacher, ramped EMA."""

    with_teacher = True
    default_logger_cls = AdaMTLogger
    image_tags = ("target_inputs", "weak_aug1", "weak_aug2", "teacher_predictions",
                  "teacher_consensus", "target_ground_truth", "model_samples")

    def __init__(self, *args, momentum: float = 0.999, do_consensus_masking: bool = False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.momentum = momentum
        self.do_consensus_masking = do_consensus_masking

    def make_train_step(self):
        return steps_lib.make_adamt_step(momentum=self.momentum,
                                         do_consensus_masking=self.do_consensus_masking)

    def make_val_step(self):
        return steps_lib.make_adamt_val_step(do_consensus_masking=self.do_consensus_masking)

    def make_panel_fn(self):
        return steps_lib.make_adamt_panels(do_consensus_masking=self.do_consensus_masking)


class AdaMatchTrainer(_JointTrainer):
    """Joint FixMatch, no teacher."""

    default_logger_cls = AdaMatchLogger
    image_tags = ("target_inputs", "weak_aug", "strong_aug", "weak_model_predictions",
                  "weak_model_consensus", "target_ground_truth", "model_samples")

    def __init__(self, *args, do_consensus_masking: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.do_consensus_masking = do_consensus_masking

    def make_train_step(self):
        return steps_lib.make_adamatch_step(do_consensus_masking=self.do_consensus_masking)

    def make_val_step(self):
        return steps_lib.make_adamatch_val_step(do_consensus_masking=self.do_consensus_masking)

    def make_panel_fn(self):
        return steps_lib.make_adamatch_panels(do_consensus_masking=self.do_consensus_masking)
