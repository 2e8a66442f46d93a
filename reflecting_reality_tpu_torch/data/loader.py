"""Batched, prefetching data loader, the port's counterpart of
`reflecting_reality_tpu/data/loader.py` (reference: torch DataLoader +
Accelerate prepare, train_brushnet_mirror.py:1242-1269).

Host side: a thread pool maps `dataset.__getitem__` (h5py, PIL and the
native transforms release the interpreter lock) and `collate` stacks NHWC
numpy batches (reference collate_fn :796-835).

`prefetch_to_device` keeps batches in flight to the card, off the
step's critical path: a producer thread stacks (and, for `group` K > 1,
groups K batches into one (K, B, ...) upload), casts float32 to the
transport dtype on the host while packing the whole batch into one pinned
host buffer taken from a small ring, and issues that buffer's one
host-to-device copy on a side CUDA stream, recording an event.  The
consumer makes its current stream wait on that event before it hands the
batch out, and marks the device buffer with `record_stream`, so the caching
allocator does not reuse it while the consumer's stream may still read it.
A pinned buffer is refilled only after the copy out of it has completed
(its event).  On the CPU the same batches are yielded as plain CPU tensors.
The consumer's wait for the next batch is the `rr.loader.wait` span.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Union

import numpy as np
import torch

from reflecting_reality_tpu_torch.core import tracing


def collate(examples) -> Dict[str, np.ndarray]:
    batch = {}
    for key in examples[0]:
        batch[key] = np.ascontiguousarray(np.stack([e[key] for e in examples]))
        if batch[key].dtype == np.float64:
            batch[key] = batch[key].astype(np.float32)
    return batch


class DataLoader:
    """Shuffling, drop-last, thread-parallel batch loader.

    `batch_size` is the global batch.  Each pass shuffles with
    `RandomState(seed + epoch)` and sets the dataset's item-RNG epoch, so
    every draw depends on (seed, epoch, index) only.  With process_count > 1
    every process draws the same order and reads its contiguous slice of each
    global batch (the training CLIs' data-parallel runs, JAX
    `cli/train.py:273-282`)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, seed: int = 0, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1):
        if batch_size % max(process_count, 1):
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"process_count {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = max(process_count, 1)
        self.local_batch_size = batch_size // self.process_count
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last or self.process_count > 1:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        ds_rng = getattr(self.dataset, "rng", None)
        if ds_rng is not None and hasattr(ds_rng, "epoch"):
            ds_rng.epoch = self.epoch
        self.epoch += 1

        lo = self.process_index * self.local_batch_size
        # a partial tail batch would give processes unequal slices
        drop = self.drop_last or self.process_count > 1
        stop = n - (n % self.batch_size) if drop else n
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            for start in range(0, stop, self.batch_size):
                idxs = order[start + lo: start + lo + self.local_batch_size]
                pending.append(pool.map(self.dataset.__getitem__, idxs))
                if len(pending) > 2:              # keep 2 batches in flight
                    yield collate(list(pending.pop(0)))
            for fut in pending:
                yield collate(list(fut))


def _grouped(iterator: Iterable[Dict[str, np.ndarray]], group: int):
    """K consecutive batches stacked into (K, B, ...); a partial group at the
    end is yielded with a shorter leading dim."""
    buf = []
    for b in iterator:
        buf.append(b)
        if len(buf) == group:
            yield {k: np.stack([x[k] for x in buf]) for k in buf[0]}
            buf = []
    if buf:
        yield {k: np.stack([x[k] for x in buf]) for k in buf[0]}


def _host_tensors(batch: Dict[str, np.ndarray], transport_dtype: Optional[torch.dtype],
                  exempt: tuple) -> Dict[str, torch.Tensor]:
    """numpy batch -> CPU tensors, float32 cast to the transport dtype except
    exempt keys."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if transport_dtype is not None and k not in exempt and t.dtype == torch.float32:
            t = t.to(transport_dtype)
        out[k] = t
    return out


_ALIGN = 64      # byte alignment of each array in a packed upload


def _view(flat: torch.Tensor, offset: int, dtype: torch.dtype, shape) -> torch.Tensor:
    """The array at `offset` of a packed uint8 buffer."""
    n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return flat[offset: offset + n].view(dtype).view(shape)


def _pack(batch: Dict[str, np.ndarray], transport_dtype: Optional[torch.dtype], exempt: tuple,
          flat: Optional[torch.Tensor] = None, pin: bool = False):
    """The batch packed into one uint8 buffer (`flat` reused if it is large
    enough, else a new one, pinned if `pin`): each array cast to its transport
    dtype and 64-byte aligned -> (the buffer, [(key, offset, dtype, shape)],
    the packed size in bytes)."""
    srcs, layout, size = {}, [], 0
    for k, v in batch.items():
        src = srcs[k] = torch.from_numpy(np.asarray(v))
        dtype = src.dtype
        if transport_dtype is not None and k not in exempt and dtype == torch.float32:
            dtype = transport_dtype
        layout.append((k, size, dtype, src.shape))
        size += -(-src.numel() * dtype.itemsize // _ALIGN) * _ALIGN
    if flat is None or flat.numel() < size:
        flat = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
    for k, offset, dtype, shape in layout:
        _view(flat, offset, dtype, shape).copy_(srcs[k])      # the transport cast
    return flat, layout, size


class _PinnedSlot:
    """A pinned host buffer for one packed batch, so a batch crosses in one
    copy, and the event of the last copy out of it."""

    def __init__(self):
        self.flat: Optional[torch.Tensor] = None
        self.copied: Optional[torch.cuda.Event] = None

    def fill(self, batch: Dict[str, np.ndarray], transport_dtype, exempt):
        if self.copied is not None:
            self.copied.synchronize()     # the previous upload has read the buffer
        self.flat, layout, size = _pack(batch, transport_dtype, exempt, self.flat, pin=True)
        return self.flat[:size], layout


def prefetch_to_device(iterator: Iterable[Dict[str, np.ndarray]],
                       device: Union[str, torch.device, None] = None, group: int = 1,
                       transport_dtype: Optional[torch.dtype] = None,
                       transport_exempt: tuple = (),
                       h2d_events: Optional[List] = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Host batches -> batches on `device` ("cuda" by default), 2 in flight
    (1 when `group` > 1: one super-batch ahead already hides the upload).
    `group` K > 1 stacks K batches into one (K, B, ...) upload.
    `transport_dtype` (e.g. torch.bfloat16) casts
    float32 arrays on the host before the upload; integer arrays and keys in
    `transport_exempt` are left alone.  `h2d_events`, when given, receives
    one (start, end) pair of CUDA events per upload, recorded around its
    copy on the side stream.  Closing the generator stops the producer
    thread and joins it."""
    device = torch.device("cuda" if device is None else device)
    if group > 1:
        iterator = _grouped(iterator, group)
    size = 1 if group > 1 else 2
    on_card = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if not on_card:
                for batch in iterator:
                    if not put(_host_tensors(batch, transport_dtype, transport_exempt)):
                        return
                return
            with torch.cuda.device(device):
                side = torch.cuda.Stream(device)
                slots = [_PinnedSlot() for _ in range(size + 2)]
                for i, batch in enumerate(iterator):
                    slot = slots[i % len(slots)]
                    flat, layout = slot.fill(batch, transport_dtype, transport_exempt)
                    start = torch.cuda.Event(enable_timing=h2d_events is not None)
                    end = torch.cuda.Event(enable_timing=h2d_events is not None)
                    with torch.cuda.stream(side):
                        start.record(side)
                        dev_flat = flat.to(device, non_blocking=True)
                        end.record(side)
                    slot.copied = end
                    dev = {k: _view(dev_flat, off, dt, shape) for k, off, dt, shape in layout}
                    if not put((dev, dev_flat, start, end)):
                        return
        except BaseException as e:  # handed to the consumer, which re-raises it
            put(e)
        finally:
            put(done)

    thread = threading.Thread(target=producer, daemon=True, name="prefetch_to_device")
    thread.start()
    consumer = torch.cuda.current_stream(device) if on_card else None
    try:
        while True:
            with tracing.span("rr.loader.wait"):
                item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            if not on_card:
                yield item
                continue
            batch, dev_flat, start, end = item
            consumer.wait_event(end)
            dev_flat.record_stream(consumer)      # the storage of every array in `batch`
            if h2d_events is not None:
                h2d_events.append((start, end))
            yield batch
    finally:
        stop.set()
        while thread.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        thread.join()
