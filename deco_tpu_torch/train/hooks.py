"""Run-loop hooks: sample images, the ADM npz, scalar logs, predict metrics
(``deco_tpu/train/hooks.py``).

- :class:`SaveImagesHook`: each sample's ``save_fn`` on a thread pool (up
  to ``max_save_images``), and with ``save_compressed`` every image into
  ``output.npz`` under key ``arr_0``, the file the ADM FID suite reads.
- :class:`ScalarLogger`: step scalars to ``metrics.jsonl``, one JSON object
  a line with ``step``, ``time`` and each metric, to TensorBoard when
  ``torch.utils.tensorboard`` imports, and to W&B when a project is named
  and ``wandb`` imports (:func:`_maybe_wandb`).
- :class:`ImageLogger`: sample panels, and original|reconstruction pairs
  side by side, as PNG under ``images/``.
- :class:`ComputeMetricsHook`: PSNR, SSIM and FID of predicted against
  original images, accumulated over a predict run.

Under several processes (``parallel/distributed.py``): the scalar log is
rank 0's (``writer``), each data rank saves its own samples by their
global index and ``output.npz`` is merged in the global order, and the
metrics' sums and FID moments are summed over the processes.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

import torch

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models import inception
from deco_tpu_torch.parallel import distributed
from deco_tpu_torch.train.metrics import (
    FIDStats,
    frechet_distance,
    psnr_from_stats,
    squared_error_stats,
    ssim,
)
from deco_tpu_torch.utils import png


def _tensorboard(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:  # the tensorboard package is optional
        return None
    return SummaryWriter(logdir)


class SaveImagesHook:
    def __init__(self, save_dir: str, save_compressed: bool = False,
                 max_save_images: int = 10, num_threads: int = 8):
        self.save_dir = save_dir
        self.save_compressed = save_compressed
        self.max_save_images = max_save_images
        self.num_threads = num_threads
        self._pool: Optional[ThreadPoolExecutor] = None
        self._accum = []
        self._saved = 0
        self._futures = []

    def on_predict_start(self, workdir: str, step: int = 0, process_index: int = 0,
                         process_count: int = 1, writes: bool = True):
        """``process_index`` of ``process_count``: this rank of the data axis,
        whose batches are its rows of each global batch; ``writes``: whether
        this rank saves (one rank of each model group does)."""
        self.root = os.path.join(workdir, self.save_dir, f"iter_{step}")
        os.makedirs(self.root, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=self.num_threads)
        self._accum = []
        self._saved = 0
        self._futures = []
        self._shard = (process_index, process_count, writes)

    def on_predict_batch_end(self, images_uint8: np.ndarray, metadata: dict,
                             first_index: Optional[int] = None):
        """images: (B, H, W, 3) uint8 on the host; metadata from the loader's
        collate. ``first_index``: the first image's index in the whole
        predict (a data rank's rows): the first ``max_save_images`` of the
        whole predict are saved; without it, the first of this hook's."""
        batch = images_uint8.shape[0]
        save_fns = metadata.get("save_fn", [None] * batch)

        def per_sample(v, i):
            # the text conditioner writes tensors (valid_length_y): anything
            # array-like with a leading batch dim is sliced per sample
            if isinstance(v, list):
                return v[i] if len(v) == batch else v
            if isinstance(v, np.ndarray):
                return v[i] if v.ndim >= 1 and len(v) == batch else v
            if hasattr(v, "__array__") and not isinstance(v, (str, bytes)):
                arr = np.asarray(v)
                return arr[i] if arr.ndim >= 1 and len(arr) == batch else arr
            return v

        for i in range(batch):
            md = {k: per_sample(v, i) for k, v in metadata.items() if k != "save_fn"}
            fn = save_fns[i] if isinstance(save_fns, list) else save_fns
            order = self._saved if first_index is None else first_index + i
            if fn is not None and order < self.max_save_images:
                self._futures.append(self._pool.submit(fn, images_uint8[i], md, self.root))
                self._saved += 1
        if self.save_compressed:
            self._accum.append(images_uint8)

    def on_predict_end(self) -> Optional[str]:
        """Waits for the image writes; returns the npz path (or None). Under
        several data ranks every process calls it: each writing rank leaves
        its rows, and data rank 0 merges them in the global order (rank-major
        within each batch) and removes the parts."""
        try:
            for f in self._futures:
                f.result()
        finally:
            self._pool.shutdown()
        index, count, writes = self._shard
        if not self.save_compressed:
            return None
        if count == 1:
            if not self._accum:
                return None
            out_path = os.path.join(self.root, "output.npz")
            np.savez(out_path, arr_0=np.concatenate(self._accum, axis=0))  # ADM suite: key arr_0
            return out_path
        part = os.path.join(self.root, f"output_rank{index}.npy")
        if writes:
            np.save(part, np.stack(self._accum) if self._accum else np.zeros((0,)))
        distributed.barrier()
        out_path = None
        if writes and index == 0:
            parts = [np.load(os.path.join(self.root, f"output_rank{r}.npy")) for r in range(count)]
            if parts[0].size:
                merged = np.stack(parts, axis=1)  # (batches, ranks, rows, ...)
                out_path = os.path.join(self.root, "output.npz")
                np.savez(out_path, arr_0=merged.reshape((-1,) + merged.shape[3:]))
            for r in range(count):
                os.remove(os.path.join(self.root, f"output_rank{r}.npy"))
        distributed.barrier()
        return out_path


class ComputeMetricsHook:
    """Streaming PSNR, SSIM and FID of predicted against original batches,
    the torchmetrics protocol of the reference's hook: PSNR pools one
    squared error over the run (``dim=None``), SSIM averages the per-image
    means, FID compares the Inception statistics of the originals (real)
    and the predictions (fake). Each batch is scored on ``device``; the
    sums and the FID moments are float64 on the host.

    ``inception`` is a state-dict path (:func:`~deco_tpu_torch.models.inception.load_inception`),
    a tower, or None for the tower drawn from seed 0, whose FIDs compare
    only with each other. One process: there is no cross-host merge.
    """

    def __init__(self, compute_fid: bool = True, fid_feature_dim: int = 2048,
                 data_range: float = 255.0, inception=None, device="cuda"):
        self.compute_fid = compute_fid
        self.data_range = data_range
        self.inception = inception
        self.device = resolve_device(device)
        self._fid_dim = fid_feature_dim
        self._tower = None
        self.reset()

    def reset(self):
        self._sse = 0.0
        self._n_obs = 0.0
        self._ssim_sum = 0.0
        self._n_images = 0.0
        self._real = FIDStats(self._fid_dim)
        self._fake = FIDStats(self._fid_dim)

    @property
    def has_updates(self) -> bool:
        """True once a batch went through :meth:`on_batch_end`."""
        return bool(self._n_images)

    def any_rank_has_updates(self) -> bool:
        """:attr:`has_updates` of any process (every process calls it)."""
        return bool(np.sum(distributed.process_allgather(np.float64(self._n_images))))

    def tower(self):
        """The Inception tower at this hook's tap, built on first use."""
        if self._tower is None:
            if isinstance(self.inception, str):
                self._tower = inception.load_inception(self.inception, device=self.device,
                                                       feature_dim=self._fid_dim)
            elif self.inception is None:
                self._tower = inception.random_inception(0, device=self.device,
                                                         feature_dim=self._fid_dim)
            else:
                self._tower = self.inception
        return self._tower

    @torch.no_grad()
    def on_batch_end(self, pred_uint8: np.ndarray, original_uint8: np.ndarray):
        """Both (B, H, W, 3) uint8 host arrays (``fp_to_uint8`` output)."""
        pred = torch.from_numpy(np.asarray(pred_uint8)).to(self.device).float()
        orig = torch.from_numpy(np.asarray(original_uint8)).to(self.device).float()
        # torchmetrics with a (0, range) tuple clamps first (a no-op on uint8)
        p, o = pred.clamp(0, self.data_range), orig.clamp(0, self.data_range)
        sse, n = squared_error_stats(p, o)
        self._sse += sse
        self._n_obs += n
        self._ssim_sum += float(ssim(p, o, data_range=self.data_range, per_image=True)
                                .double().sum())
        self._n_images += float(p.shape[0])
        if self.compute_fid:
            tower = self.tower()
            self._real.update(tower(orig / 255.0).cpu().numpy())
            self._fake.update(tower(pred / 255.0).cpu().numpy())

    def on_epoch_end(self, prefix: str = "metrics") -> dict:
        """The run's scores (``{prefix}/psnr``, ``/ssim``, ``/fid``); resets.
        Under several processes every one calls it, and the sums and the FID
        moments are those of all of them."""
        if distributed.world_size() > 1:
            sums = distributed.process_allgather(
                np.asarray([self._sse, self._n_obs, self._ssim_sum, self._n_images]))
            self._sse, self._n_obs, self._ssim_sum, self._n_images = sums.sum(0)
            for stats in (self._real, self._fake):
                total = distributed.process_allgather(
                    np.concatenate([[stats.n], stats.s1, stats.s2.ravel()])).sum(0)
                stats.n = int(total[0])
                stats.s1 = total[1:1 + len(stats.s1)]
                stats.s2 = total[1 + len(stats.s1):].reshape(stats.s2.shape)
        out = {}
        if self._n_images:
            out[f"{prefix}/psnr"] = psnr_from_stats(self._sse, self._n_obs,
                                                    data_range=self.data_range)
            out[f"{prefix}/ssim"] = self._ssim_sum / self._n_images
        if self.compute_fid and self._real.n > 1:
            out[f"{prefix}/fid"] = frechet_distance(*self._real.finalize(),
                                                    *self._fake.finalize())
        self.reset()
        return out


class ImageLogger:
    """Predict-time sample panels as PNG under ``<workdir>/<subdir>`` (and
    TensorBoard when a writer is given)."""

    def __init__(self, workdir: str, subdir: str = "images", max_images: int = 16,
                 tb_writer=None):
        self.root = os.path.join(workdir, subdir)
        os.makedirs(self.root, exist_ok=True)
        self.max_images = max_images
        self._tb = tb_writer
        self._count = 0

    def _write(self, panel_uint8: np.ndarray, name: str, step: int):
        png.write(os.path.join(self.root, f"{name}_step{step}_{self._count:03d}.png"),
                  panel_uint8)
        if self._tb is not None:
            self._tb.add_image(f"images/{name}", panel_uint8, step, dataformats="HWC")

    def log_side_by_side(self, step: int, originals_uint8: np.ndarray,
                         recons_uint8: np.ndarray, name: str = "reconstruction"):
        """(B, H, W, 3) uint8 pairs, one original|reconstruction panel each."""
        n = min(len(originals_uint8), self.max_images - self._count)
        for i in range(max(n, 0)):
            self._write(np.concatenate([originals_uint8[i], recons_uint8[i]], axis=1), name, step)
            self._count += 1

    def log_images(self, step: int, images_uint8: np.ndarray, name: str = "samples"):
        """(B, H, W, 3) uint8 generated samples, one panel each."""
        n = min(len(images_uint8), self.max_images - self._count)
        for i in range(max(n, 0)):
            self._write(images_uint8[i], name, step)
            self._count += 1


def _maybe_wandb(workdir: str, project: Optional[str], config: Optional[dict]):
    """A W&B run for ``project`` (or the ``WANDB_PROJECT`` variable), or None
    where neither names one or ``wandb`` does not import or start: the
    config's ``WandbLogger`` node is read and never refused, and the JSONL
    and TensorBoard logs stay in every case."""
    project = project or os.environ.get("WANDB_PROJECT")
    if not project:
        return None
    try:
        import wandb

        return wandb.init(project=project, dir=workdir,
                          name=os.path.basename(os.path.abspath(workdir)), config=config,
                          resume="allow")
    except Exception:  # no wandb, or a run that cannot start (no login, no network)
        return None


class ScalarLogger:
    """``metrics.jsonl`` + optional TensorBoard and W&B step-scalar logger.

    :meth:`log` converts the metrics (0-d tensors on the card) to floats only
    on log steps, so other steps read nothing back from the device.
    """

    def __init__(self, workdir: str, use_tensorboard: bool = True,
                 log_every_n_steps: int = 50, wandb_project: Optional[str] = None,
                 run_config: Optional[dict] = None, writer: bool = True):
        self.writer = writer
        if not writer:  # another rank logs
            return
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self.log_every_n_steps = log_every_n_steps
        self._tb = _tensorboard(os.path.join(workdir, "tb")) if use_tensorboard else None
        self._wandb = _maybe_wandb(workdir, wandb_project, run_config)
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, force: bool = False):
        if not self.writer or (not force and step % self.log_every_n_steps != 0):
            return
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in record.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "step"}, step=step)

    def close(self):
        if not self.writer:
            return
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
