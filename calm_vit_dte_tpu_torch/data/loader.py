"""Host-side datasets and the threaded prefetching batch loader.

JAX counterpart: calm_vit_dte_tpu/data/loader.py (copied: the port imports
nothing of the JAX package). It replaces the reference's torchvision
ImageNet dataset + DataLoader (num_workers=5, pin_memory; reference
distributed_trainer_cls.py:62,140-144). Host work is only decode + resize
to uint8; every augmentation runs on the device (data/augment.py). Decoded
batches flow from worker threads through a bounded set of slots, so decode
overlaps device compute.

Datasets:
  ImageFolderDataset  ImageNet-layout tree (root/<split>/<wnid>/*.JPEG),
                      classes sorted by name, batches decoded by the
                      native data plane (data/native.py), Pillow per image
                      where it cannot;
  SyntheticDataset    deterministic index-seeded random images, for
                      benchmarks and tests when no dataset is mounted.
"""

from __future__ import annotations

import os
import pathlib
import queue
import threading
import time

import numpy as np

from calm_vit_dte_tpu_torch.data import native
from calm_vit_dte_tpu_torch.data.sampler import ShardedSampler

_EXTS = {".jpeg", ".jpg", ".png", ".bmp", ".webp"}


class ImageFolderDataset:
    def __init__(self, root: str, split: str = "train", size: int = 256):
        self.size = size
        base = pathlib.Path(root) / split
        if not base.is_dir():
            raise FileNotFoundError(f"dataset split not found: {base}")
        self.classes = sorted(p.name for p in base.iterdir() if p.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[tuple[str, int]] = []
        for c in self.classes:
            for f in sorted((base / c).iterdir()):
                if f.suffix.lower() in _EXTS:
                    self.samples.append((str(f), self.class_to_idx[c]))
        self.decoder: str | None = None
        self.decoder_reason: str | None = None
        self.pillow_images = 0
        self._count_lock = threading.Lock()   # loader threads share it

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def load(self, idx: int) -> tuple[np.ndarray, int]:
        # Pillow is imported here, not with the module: only a run over
        # real images needs it.
        from PIL import Image

        path, label = self.samples[idx]
        with Image.open(path) as im:
            im = im.convert("RGB").resize((self.size, self.size),
                                          Image.BILINEAR)
            return np.asarray(im, dtype=np.uint8), label

    def load_batch(self, idxs) -> tuple[np.ndarray, np.ndarray]:
        """Decode a batch through the native C++ data plane (GIL-free
        threads: JPEG decode + antialiased resize), as the JAX package's
        loader does, with Pillow per image for what it reports not ok (PNG,
        CMYK, truncated files). Pillow decodes the whole batch only when the
        native library is unavailable or CALM_NATIVE_DECODE=0 (the JAX
        package's switch). `decoder` ("native" or "pillow"),
        `decoder_reason` (why Pillow, or None) and `pillow_images` (images
        Pillow decoded so far) say what ran."""
        labels = np.asarray([self.samples[int(i)][1] for i in idxs],
                            np.int32)
        if os.environ.get("CALM_NATIVE_DECODE") == "0":
            self.decoder_reason = "CALM_NATIVE_DECODE=0"
        else:
            self.decoder_reason = native.unavailable_reason()
        self.decoder = "pillow" if self.decoder_reason else "native"
        if self.decoder == "native":
            paths = [self.samples[int(i)][0] for i in idxs]
            imgs, ok = native.decode_resize_batch(paths, self.size)
            failed = np.nonzero(~ok)[0]
        else:
            imgs = np.empty((len(idxs), self.size, self.size, 3), np.uint8)
            failed = range(len(idxs))
        for j in failed:
            imgs[j], _ = self.load(int(idxs[j]))
        with self._count_lock:
            self.pillow_images += len(failed)
        return imgs, labels


class SyntheticDataset:
    """Deterministic fake ImageNet: index-seeded uint8 images."""

    def __init__(self, n: int = 50000, num_classes: int = 1000,
                 size: int = 256):
        self.n = n
        self.num_classes = num_classes
        self.size = size

    def __len__(self) -> int:
        return self.n

    def load(self, idx: int) -> tuple[np.ndarray, int]:
        rng = np.random.default_rng(idx)
        img = rng.integers(0, 256, (self.size, self.size, 3), dtype=np.uint8)
        return img, int(idx % self.num_classes)


class BatchLoader:
    """Threaded prefetching loader: yields {'image': u8 (B,S,S,3),
    'label': i32 (B,)} numpy batches for one epoch."""

    def __init__(self, dataset, sampler: ShardedSampler, batch_size: int,
                 num_workers: int = 5, prefetch: int = 4,
                 drop_last: bool = True, pad_last: bool = False):
        """pad_last=True (implies drop_last=False): the final partial batch
        is padded to full batch_size by wrapping, and every batch carries a
        'valid' bool array marking real entries, so shapes stay fixed while
        an evaluation covers each sample exactly once (combined with
        ShardedSampler.valid_mask)."""
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        # Workers beyond the host's cores only thrash.
        self.num_workers = max(1, min(num_workers,
                                      os.cpu_count() or num_workers))
        self.prefetch = prefetch
        self.drop_last = drop_last and not pad_last
        self.pad_last = pad_last

    def steps_per_epoch(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        indices = self.sampler.indices()
        nb = self.steps_per_epoch()
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        valids = None
        if self.pad_last:
            valid_all = (self.sampler.valid_mask()
                         if hasattr(self.sampler, "valid_mask")
                         else np.ones(len(indices), bool))
            valids = [valid_all[i * self.batch_size:(i + 1) * self.batch_size]
                      for i in range(nb)]
            for i, (b, v) in enumerate(zip(batches, valids)):
                short = self.batch_size - len(b)
                if short > 0:
                    batches[i] = np.concatenate([b, indices[:short]])
                    valids[i] = np.concatenate([v, np.zeros(short, bool)])
        task_q: queue.Queue = queue.Queue()
        results: dict[int, dict] = {}
        lock = threading.Lock()
        # Backpressure: at most prefetch + num_workers batches in flight.
        budget = threading.Semaphore(self.prefetch + self.num_workers)
        for i, b in enumerate(batches):
            task_q.put((i, b))

        def worker():
            while True:
                # Acquire before claiming a task: tokens then always belong
                # to claimed tasks, and FIFO claiming keeps the lowest
                # unconsumed batch in flight, so there is no deadlock.
                budget.acquire()
                try:
                    i, idxs = task_q.get_nowait()
                except queue.Empty:
                    budget.release()
                    return
                try:
                    if hasattr(self.dataset, "load_batch"):
                        imgs, labels = self.dataset.load_batch(idxs)
                    else:
                        imgs = np.empty((len(idxs), self.dataset.size,
                                         self.dataset.size, 3), np.uint8)
                        labels = np.empty((len(idxs),), np.int32)
                        for j, idx in enumerate(idxs):
                            imgs[j], labels[j] = self.dataset.load(int(idx))
                    payload = {"image": imgs, "label": labels}
                    if valids is not None:
                        payload["valid"] = valids[i]
                except BaseException as e:
                    # A failing worker still publishes a result, so the
                    # consumer raises instead of waiting forever on a slot
                    # that would never fill.
                    payload = e
                with lock:
                    results[i] = payload

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        next_idx = 0
        while next_idx < nb:
            with lock:
                batch = results.pop(next_idx, None)
            if batch is None:
                time.sleep(0.002)
                continue
            budget.release()
            if isinstance(batch, BaseException):
                raise RuntimeError(
                    f"data worker failed on batch {next_idx}") from batch
            yield batch
            next_idx += 1
