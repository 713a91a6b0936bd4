"""Host-side batch prefetcher for the streaming ray store (upnerf/data/prefetch.py).

When the compact ray store does not fit on the device (downscale-1
Phototourism scenes: `tpu.store_on_device false`), batches are gathered from
the host arrays, memmaps of the .npy cache included, on a background thread
that keeps `depth` batches ready, so the gather and the copy to the device
overlap the device's step.

A seed gives the JAX prefetcher's batches: the same np.random.RandomState
draws `randint(0, n_rays, batch_size)` per batch, sorted (sorted gathers are
much faster on memmaps), and the same conversions (px, py, inv_depth to f32,
rgb / 255). img_idx goes to the device as int64, the device store's dtype.

On a CUDA device the gathered arrays go into pinned host tensors and are
copied with non_blocking=True on a dedicated stream; the batch carries that
copy's event and `__next__` makes the current stream wait on it before
handing the batch out. On the CPU the batch is a plain copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

KEYS = ("px", "py", "img_idx", "rgb", "inv_depth")


def gather(store_np: Dict[str, np.ndarray], idx: np.ndarray) -> Dict[str, np.ndarray]:
    """One batch of the host store at sorted flat indices idx, in the batch dtypes."""
    s = store_np
    return {
        "px": s["px"][idx].astype(np.float32),
        "py": s["py"][idx].astype(np.float32),
        "img_idx": s["img_idx"][idx].astype(np.int64),
        "rgb": s["rgb"][idx].astype(np.float32) / 255.0,
        "inv_depth": s["inv_depth"][idx].astype(np.float32),
    }


class BatchPrefetcher:
    def __init__(self, store_np: Dict[str, np.ndarray], batch_size: int, device="cpu", seed: int = 0,
                 depth: int = 2):
        self.store = store_np
        self.batch_size = batch_size
        self.n_rays = int(store_np["px"].shape[0])
        self.device = torch.device(device)
        self._stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._rng = np.random.RandomState(seed)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _gather(self) -> Dict[str, np.ndarray]:
        idx = self._rng.randint(0, self.n_rays, self.batch_size)
        idx.sort()
        return gather(self.store, idx)

    def _to_device(self, host: Dict[str, np.ndarray]):
        """(batch on the device, the copy's event or None)."""
        if self._stream is None:
            return {k: torch.from_numpy(host[k]).to(self.device) for k in KEYS}, None
        pinned = {k: torch.from_numpy(host[k]).pin_memory() for k in KEYS}
        with torch.cuda.stream(self._stream):
            batch = {k: v.to(self.device, non_blocking=True) for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return batch, event

    def _worker(self):
        try:
            while not self._stop.is_set():
                item = self._to_device(self._gather())
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaces in __next__ rather than a silent hang
            self._error = e

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        while True:
            try:
                batch, event = self._q.get(timeout=0.25)
                break
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError("the batch prefetcher's thread failed") from self._error
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
            for v in batch.values():  # the copy stream's memory is now used on the consumer's stream
                v.record_stream(torch.cuda.current_stream(self.device))
        return batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
