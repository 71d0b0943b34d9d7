"""Device input feed: stage stereo pairs onto the card ahead of use (port of
``stereoslam_tpu/utils/feed.py`` ``DeviceFeed`` and ``BatchFeed``).

A background thread stacks frame t+1..t+depth into pinned host buffers and
copies each one to the card with a non-blocking copy on a side CUDA stream,
while the card computes frame t.  Stream order is what keeps this correct:
the consumer's stream waits on the event recorded after each copy before it
reads the frame, and the frame's memory is recorded on the consumer's stream,
so the allocator does not hand it to the side stream again while the
consumer's work on it is queued.  A pinned buffer is refilled only after the
copy out of it has finished.

On a CPU device the feed is a plain iterator over the stacked frames (the
caller asked for the CPU: there is no transfer to hide).

Usage::

    feed = DeviceFeed(((seq.left[t], seq.right[t], seq.timestamps[t])
                       for t in range(n)))
    for lr_dev, ts in feed:
        if not slam.process_staged(lr_dev, ts):
            break
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

_SENTINEL = object()




class DeviceFeed:
    """Iterate ``(stacked (2, H, W) uint8 pair on the device, timestamp)``.

    Args:
      frames: iterable of ``(left, right, timestamp)`` host frames.
      depth: number of frames staged ahead (2-3 hides the transfer without
        holding many image buffers on the card).
      device: where the pairs go: the card unless the caller asks for
        ``"cpu"``.
    """

    def __init__(self, frames: Iterable[Tuple[np.ndarray, np.ndarray, float]],
                 depth: int = 3, device=None):
        self.device = torch.device(device or "cuda")
        self._frames = frames
        if self.device.type != "cuda":
            return
        if not torch.cuda.is_available():
            raise RuntimeError("DeviceFeed stages onto the card by default and no CUDA device is "
                               "available: pass device='cpu' to iterate on the CPU")
        self._depth = max(1, int(depth))
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(iter(frames),), daemon=True)
        self._thread.start()

    @staticmethod
    def _host(item):
        """(the uint8 stack to stage, its timestamp) of one host item."""
        left, right, ts = item
        return np.stack([np.asarray(left), np.asarray(right)]).astype(np.uint8), float(ts)

    def _run(self, it) -> None:
        try:
            with torch.cuda.device(self.device):
                stream = torch.cuda.Stream(self.device)
                # depth items may sit in the queue and one more with the
                # consumer; one more is being filled.
                slots = [None] * (self._depth + 2)
                for k, item in enumerate(it):
                    if self._stop.is_set():
                        return
                    lr, ts = self._host(item)
                    slot = slots[k % len(slots)]
                    if slot is None or slot[0].shape != lr.shape:
                        slot = [torch.empty(lr.shape, dtype=torch.uint8, pin_memory=True), None]
                        slots[k % len(slots)] = slot
                    elif slot[1] is not None:
                        slot[1].synchronize()  # the last copy out of this buffer has landed
                    slot[0].numpy()[...] = lr
                    with torch.cuda.stream(stream):
                        dev = slot[0].to(self.device, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(stream)
                    slot[1] = done
                    self._put((dev, ts, done))
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._put(_SENTINEL)

    def _put(self, item) -> None:
        # Bounded put that honors close(): a consumer that stops iterating
        # early (tracking LOST breaks the loop) must not leave this thread
        # parked forever on a full queue.  The sentinel MUST reach the
        # consumer too, or it blocks on get() once the queue drains.
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def close(self) -> None:
        """Stop the producer thread and release staged buffers.  Idempotent;
        called automatically when iteration finishes OR is abandoned early."""
        if self.device.type != "cuda":
            return
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=2.0)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, float]]:
        if self.device.type != "cuda":
            for item in self._frames:
                lr, ts = self._host(item)
                yield torch.from_numpy(lr), ts
            return
        try:
            while True:
                item = self._q.get()
                if item is _SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                dev, ts, done = item
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(done)
                dev.record_stream(consumer)
                yield dev, ts
        finally:
            # Runs on normal exhaustion AND when the consumer abandons the
            # generator (break / exception).
            self.close()


class BatchFeed(DeviceFeed):
    """Staging feed of the batched multi-sequence mode
    (:class:`~stereoslam_tpu_torch.parallel.multiseq.MultiSeqVO`): iterates
    ``(stack, ts)`` where ``stack`` is ONE (B, 2, H, W) uint8 tensor on the
    device a step and ``ts`` a float32 (B,) numpy vector, staged and
    delivered exactly as :class:`DeviceFeed` stages a pair (pinned buffers,
    non-blocking copies on a side stream, the same lifecycle).

    Args:
      frames: iterable of ``(left_B, right_B, ts_B)`` host batches: (B, H, W)
        images and B timestamps.
      depth, device: as for :class:`DeviceFeed`.
    """

    @staticmethod
    def _host(item):
        left, right, ts = item
        lr = np.stack([np.asarray(left), np.asarray(right)], axis=1).astype(np.uint8)
        return lr, np.asarray(ts, np.float32)
