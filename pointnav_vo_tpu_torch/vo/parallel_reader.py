"""Process-parallel HDF5 decode over the shared-memory rings (counterpart
of ``vo/parallel_reader.py``).

The host's only per-batch work in VO training is HDF5 chunk decode (LZF
and reshape): depth discretisation and the top-down projection run on the
device.  libhdf5 serialises every call behind one lock, so threads do not
scale it and processes do, as the reference's DataLoader workers.

:class:`ParallelDecodeReader` takes :class:`FramePairReader` keywords:
``num_workers`` spawned processes each own a static slice of the chunk
list (``chunks[w::W]``, composed with any host shard), decode and assemble
batches as the serial reader does, and ship each pickled
``FramePairBatch`` through two SPSC rings of ``native.ShmRing`` (its
length, then its bytes).  The consumer takes the workers' batches round
robin, so an epoch's stream is fixed by the epoch's ``rng``.

Against the serial reader an epoch holds the same samples with the same
twin adjacency, in another order: a worker keeps its chunks across epochs
and shuffles them itself each epoch.  Training uses it; evaluation keeps
the serial reader and its exact-count and order contracts.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import uuid
from typing import Iterator, Optional

import numpy as np

from pointnav_vo_tpu_torch.vo.dataset import FramePairBatch, FramePairReader

_RING_SLOTS = 2  # batches a worker may run ahead of the consumer
_END_TIMEOUT_MS = 500  # one poll's wait; the worker's liveness is checked between polls
_PUSH_TIMEOUT_MS = 600_000


def _slot_bytes(batch_size: int, h: int, w: int) -> int:
    """Upper bound of one pickled FramePairBatch: uint8 rgb pairs, float16
    depth pairs, float32 metadata and pickle framing."""
    per_sample = 10 * h * w + 256
    return batch_size * per_sample + (1 << 20)


def _decode_worker(prefix: str, widx: int, reader_kwargs: dict, batch_size: int,
                   epoch_seed: Optional[int], drop_last: bool) -> None:
    from pointnav_vo_tpu_torch.native import ShmRing

    lring = ShmRing(f"{prefix}_l{widx}")
    dring = ShmRing(f"{prefix}_d{widx}")
    reader = FramePairReader(**reader_kwargs)
    rng = np.random.default_rng([epoch_seed, widx]) if epoch_seed is not None else None
    ln = np.zeros(1, np.uint64)
    for batch in reader.iter_batches(batch_size, rng=rng, drop_last=drop_last):
        blob = pickle.dumps(batch, protocol=5)
        dring.push(np.frombuffer(blob, np.uint8), timeout_ms=_PUSH_TIMEOUT_MS)
        ln[0] = len(blob)
        lring.push(ln, timeout_ms=_PUSH_TIMEOUT_MS)
    # the end marker only on a clean finish: a worker that dies must not
    # look like an empty stream (the consumer's liveness poll raises)
    ln[0] = 0
    lring.push(ln, timeout_ms=_PUSH_TIMEOUT_MS)
    lring.close()
    dring.close()


class ParallelDecodeReader:
    """An ``iter_batches`` provider over decode worker processes.

    ``reader_kwargs`` are :class:`FramePairReader` keywords; their
    ``shard_index``/``num_shards`` (a host's shard) compose with the
    workers' slices.  Every other attribute (``num_samples()``, ``paths``,
    ``chunks``, ...) is the serial reader's over the same keywords."""

    def __init__(self, reader_kwargs: dict, num_workers: int):
        if num_workers < 1:
            raise ValueError(f"num_workers must be at least 1, got {num_workers}")
        self._kwargs = dict(reader_kwargs)
        self._w = num_workers
        self._serial = FramePairReader(**reader_kwargs)

    def __getattr__(self, name):
        return getattr(self._serial, name)

    def _worker_kwargs(self, widx: int) -> dict:
        kw = dict(self._kwargs)
        s = kw.get("shard_index", 0)
        n = kw.get("num_shards", 1)
        # chunks[s::n][w::W] == chunks[s + w*n :: n*W]
        kw["shard_index"] = s + widx * n
        kw["num_shards"] = n * self._w
        return kw

    def iter_batches(self, batch_size: int, rng: Optional[np.random.Generator] = None,
                     drop_last: bool = False) -> Iterator[FramePairBatch]:
        """One epoch; ``rng`` draws the epoch's seed, and worker ``w``
        shuffles with ``default_rng([seed, w])``."""
        from pointnav_vo_tpu_torch.native import ShmRing

        epoch_seed = None if rng is None else int(rng.integers(2 ** 31 - 1))
        # not from a seeded rng: two readers in one process must not share names
        prefix = f"pnvdec_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        slot = _slot_bytes(batch_size, self._kwargs["vis_size_h"], self._kwargs["vis_size_w"])
        rings, procs = [], []
        ctx = mp.get_context("spawn")
        try:
            for i in range(self._w):
                rings.append((ShmRing(f"{prefix}_l{i}", slots=_RING_SLOTS + 1, slot_bytes=8,
                                      create=True),
                              ShmRing(f"{prefix}_d{i}", slots=_RING_SLOTS, slot_bytes=slot,
                                      create=True)))
            for i in range(self._w):
                p = ctx.Process(target=_decode_worker,
                                args=(prefix, i, self._worker_kwargs(i), batch_size,
                                      epoch_seed, drop_last), daemon=True)
                p.start()
                procs.append(p)

            live = list(range(self._w))
            ln = np.zeros(1, np.uint64)
            while live:
                for i in list(live):
                    lring, dring = rings[i]
                    while True:
                        try:
                            lring.pop_into(ln, timeout_ms=_END_TIMEOUT_MS)
                            break
                        except TimeoutError:
                            if not procs[i].is_alive():
                                raise RuntimeError(
                                    f"decode worker {i} died (exit code {procs[i].exitcode}) "
                                    "before finishing its chunk slice") from None
                    n = int(ln[0])
                    if n == 0:
                        live.remove(i)
                        continue
                    buf = np.empty(n, np.uint8)
                    dring.pop_into(buf, timeout_ms=_PUSH_TIMEOUT_MS)
                    yield pickle.loads(buf.tobytes())
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=5)
            for lring, dring in rings:
                # the creating side's close also unlinks the segment
                lring.close()
                dring.close()
