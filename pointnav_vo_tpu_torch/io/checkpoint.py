"""Checkpoint files (counterpart of ``io/checkpoint.py``) in ``torch.save``
form: atomic saves, the asynchronous writer, loading and the host RNG
bundle.

A checkpoint is one dict of tensors, numbers, strings and nested
containers.  The RL engines write the reference's ``.pth`` container
(``state_dict`` with the ``actor_critic.`` prefix) with the optimizer,
the generator states and the run's metadata beside it, so published
``.pth`` files and the port's own go through one loader.  Saves write to
``path + ".tmp"`` and rename, so a preemption mid-save never leaves a torn
file under the real name.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import random
import threading
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


class UnreadableCheckpointError(OSError):
    """A checkpoint file exists but does not load: torn, truncated or not
    a checkpoint at all."""


def rng_state_bundle() -> Dict[str, Any]:
    """Host RNG states (Python, numpy, torch's CPU generator) and, where
    CUDA is initialised, every card's default generator."""
    bundle = {
        "py_random": random.getstate(),
        "np_random": np.random.get_state(),
        "torch_cpu": torch.get_rng_state(),
    }
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        bundle["torch_cuda"] = torch.cuda.get_rng_state_all()
    return bundle


def restore_rng_state(bundle: Dict[str, Any]) -> None:
    random.setstate(bundle["py_random"])
    np.random.set_state(bundle["np_random"])
    torch.set_rng_state(bundle["torch_cpu"])
    if "torch_cuda" in bundle and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(bundle["torch_cuda"])


def generator_state(generator: torch.Generator) -> Dict[str, Any]:
    """A generator's state beside the device type it loads on."""
    return {"device": generator.device.type, "state": generator.get_state()}


def restore_generator(generator: torch.Generator, saved: Any, seed: int) -> bool:
    """Load :func:`generator_state` (or a bare state) into ``generator``.
    A state saved on another device type does not load there (a CPU
    generator takes a 5,056-byte state, a CUDA one 16 bytes), so the
    generator is seeded afresh from ``seed`` instead, as the JAX package
    seeds its key from ``SEED`` on every resume, with one log line.
    Returns whether the saved state was loaded."""
    device, state = ((saved["device"], saved["state"]) if isinstance(saved, Mapping)
                     else (None, saved))
    if device in (None, generator.device.type):
        try:
            generator.set_state(state)
            return True
        except RuntimeError:  # a bare state of another device type
            pass
    generator.manual_seed(seed)
    logging.getLogger(__name__).warning(
        "generator state saved on %s does not load on %s: seeded afresh from %d",
        device or "another device type", generator.device.type, seed)
    return False


def generator_states(generator: torch.Generator, group=None) -> Dict[str, Any]:
    """``{"generator": ...}`` of :func:`generator_state`; in a
    ``parallel.dist.Group`` also ``rank_generators``, every rank's state in
    rank order, gathered over the ranks (every rank calls it)."""
    state = generator_state(generator)
    if group is None:
        return {"generator": state}
    return {"generator": state, "rank_generators": group.all_gather_object(state)}


def restore_generators(generator: torch.Generator, state: Mapping, seed: int,
                       group=None) -> None:
    """Load what :func:`generator_states` saved.  A rank of a group takes
    its own rank's state where the checkpoint holds one for each rank of a
    group of its size, and is seeded afresh from ``(seed, rank)`` where it
    does not."""
    from pointnav_vo_tpu_torch.parallel.dist import rank_seed

    saved = state["generator"]
    if group is not None:
        gens = state.get("rank_generators") or []
        if len(gens) != group.world:
            generator.manual_seed(rank_seed(seed, group))
            return
        saved = gens[group.rank]
    restore_generator(generator, saved, rank_seed(seed, group))


def snapshot(state: Any) -> Any:
    """An owned host copy of ``state``: every tensor detached and copied to
    the CPU, every array copied, containers rebuilt.  Taken on the caller's
    thread, because the next optimizer step writes the parameters in
    place."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, np.ndarray):
        return np.array(state, copy=True)
    if isinstance(state, dict):
        return {k: snapshot(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(snapshot(v) for v in state)
    return state


def _write(path: str, host_state: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(host_state, tmp)
    os.replace(tmp, path)  # atomic: survives preemption mid-save


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    _write(path, snapshot(state))


class AsyncCheckpointWriter:
    """Overlap checkpoint serialization and disk IO with device compute.

    ``save()`` snapshots the state to host memory on the calling thread
    and hands ``torch.save`` plus the atomic rename to one FIFO worker
    thread.  The queue holds at most two snapshots, so ``save()`` blocks
    when the disk falls behind.  A failed write surfaces on the next
    ``save()``/``wait()``, never silently; ``wait()`` before a requeue or a
    return makes every queued checkpoint durable.
    """

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._errors: list = []
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            path, host_state = item
            try:
                _write(path, host_state)
            except Exception as e:  # surfaced on the next save()/wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._errors:
            raise RuntimeError(
                f"async checkpoint write failed: {self._errors[0]!r}") from self._errors.pop(0)

    def save(self, path: str, state: Dict[str, Any]) -> None:
        self._raise_pending()
        self._q.put((path, snapshot(state)))

    def wait(self) -> None:
        """Block until every enqueued checkpoint is on disk."""
        self._q.join()
        self._raise_pending()

    def drain_quietly(self) -> Optional[Exception]:
        """``wait()``, but return (not raise) a deferred write error: on
        preemption an earlier periodic checkpoint's failure must not stop
        the interrupted state's save and the requeue."""
        self._q.join()
        return self._errors.pop(0) if self._errors else None

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()  # surface any deferred write error
        else:
            # already unwinding: land what is queued, but do not mask the
            # exception in flight
            self.drain_quietly()
            self._q.put(None)
            self._thread.join()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict saved at ``path``, tensors on the CPU.

    Published reference checkpoints pickle more than tensors (their yacs
    config), so this unpickles in full (``weights_only=False``): load only
    checkpoints from a source you trust.  A missing file raises
    ``FileNotFoundError``; one that does not load raises
    :class:`UnreadableCheckpointError`.
    """
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"checkpoint not found: {path!r} (EVAL.EVAL_CKPT_PATH / RESUME_STATE_FILE)")
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except (RuntimeError, pickle.UnpicklingError, EOFError) as e:
        raise UnreadableCheckpointError(f"cannot load checkpoint {path!r}: {e}") from e


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt_") -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    files = [f for f in os.listdir(ckpt_dir) if f.startswith(prefix)]
    if not files:
        return None
    files.sort(key=lambda f: os.path.getmtime(os.path.join(ckpt_dir, f)))
    return os.path.join(ckpt_dir, files[-1])
