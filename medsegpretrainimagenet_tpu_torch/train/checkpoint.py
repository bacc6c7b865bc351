"""Checkpoint files: the port of ``train/checkpoint.py``.

A checkpoint is a ``.pt`` file written with ``torch.save`` and read back
with ``torch.load(weights_only=True)``: a model's state dict, or a small
tree of them (the optimizer's ``state_dict()`` with the host step
counters, the schedule's identity, the durable-epoch stamp).  Every write
is atomic (a temporary file, fsynced, renamed over the target), so a crash
never leaves a torn file for ``--continued`` to read.  The JAX package's
msgpack checkpoints are carried across with
``transfer.state_dict_from_jax``.  :func:`load_encoder_variables` reads the
encoder out of a pretraining checkpoint for the downstream U-Net.

:class:`AsyncCheckpointer` moves the encode and the disk write to a worker
thread.  The state it is given keeps changing in place (the next step
updates the parameters), so ``save`` first takes a snapshot in stream
order: a ``non_blocking`` copy of every card tensor into pinned host
memory, with a CUDA event the worker waits on (a CPU tensor is cloned).
The caller's thread never waits for the card.
"""
from __future__ import annotations

import io
import os
import queue
import threading
from typing import Any, Dict

import torch

__all__ = ["save_params_file", "load_params_file", "write_bytes_atomic",
           "encode_state", "AsyncCheckpointer", "save_state_file",
           "load_state_file", "load_encoder_params", "load_encoder_variables",
           "is_stat", "STAT_LEAVES"]

_SUFFIXES = (".pt", ".pth")


def _check_suffix(path: str) -> None:
    if not str(path).endswith(_SUFFIXES):
        raise ValueError(
            f"{path!r}: the port reads and writes .pt state dicts; convert "
            f"a JAX msgpack checkpoint with "
            f"medsegpretrainimagenet_tpu_torch.transfer.state_dict_from_jax")


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def encode_state(tree) -> bytes:
    """*tree* (nested dicts, lists and tensors on any device) as the bytes
    of a ``.pt`` file, tensors moved to the CPU.  Callers writing the same
    state to several files encode once and fan the bytes out."""
    buffer = io.BytesIO()
    torch.save(_map_tensors(tree, lambda t: t.detach().cpu()), buffer)
    return buffer.getvalue()


def write_bytes_atomic(path: str, blob: bytes) -> None:
    """Atomic tmp+fsync+rename write: a crash mid-write must not leave a
    truncated ``last_model_state_dict.pt`` that breaks ``--continued``.
    The data fsync before the rename matters for system (not just process)
    crashes: a journaling filesystem may make the rename durable while the
    data pages are still dirty.  The directory fsync afterwards makes the
    rename itself durable."""
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    try:
        dir_fd = os.open(dirname, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError:  # filesystems without directory fsync
        pass


def save_params_file(path: str, state) -> None:
    """Write *state* (a state dict, or a tree holding tensors) to the
    ``.pt`` file *path*, atomically, tensors moved to the CPU."""
    _check_suffix(path)
    write_bytes_atomic(path, encode_state(state))


def load_params_file(path: str) -> Dict[str, Any]:
    """Read a file written by :func:`save_params_file`, on the CPU."""
    _check_suffix(path)
    return torch.load(path, map_location="cpu", weights_only=True)


#: the optimizer, scheduler and stamp files share the model files' format
save_state_file = save_params_file
load_state_file = load_params_file

#: state-dict leaves that are BatchNorm statistics, not parameters
STAT_LEAVES = ("running_mean", "running_var", "num_batches_tracked")

#: prefixes of an encoder's subtree: a pretraining FeedForwardModel's first
#: layer, or a U-Net's encoder
_ENCODER_PREFIXES = ("layers.0.", "enc.")


def is_stat(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in STAT_LEAVES


def load_encoder_variables(path: str):
    """(parameters, BatchNorm statistics or None) of the encoder in the
    checkpoint *path*: the ``layers.0.`` subtree of a pretraining
    ``FeedForwardModel`` state dict (or a U-Net's ``enc.``), the prefix
    stripped.  Its running statistics come along: an encoder carried
    across without them would normalise eval forwards with the initial
    mean 0 and variance 1."""
    state = load_params_file(path)
    for prefix in _ENCODER_PREFIXES:
        sub = {k[len(prefix):]: v for k, v in state.items()
               if k.startswith(prefix)}
        if sub:
            break
    else:
        raise KeyError(f"checkpoint {path} has no encoder (layers.0.) "
                       f"subtree; keys: {list(state)[:8]}")
    params = {k: v for k, v in sub.items() if not is_stat(k)}
    stats = {k: v for k, v in sub.items() if is_stat(k)}
    return params, stats or None


def load_encoder_params(path: str):
    """The encoder's parameters in the checkpoint *path* (see
    :func:`load_encoder_variables`)."""
    return load_encoder_variables(path)[0]


def _snapshot(tree):
    """A copy of *tree* that later in-place updates cannot reach, and the
    CUDA event after which its card copies are complete (None if none)."""
    on_card = []

    def copy(t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            on_card.append(host)
            return host
        return t.clone()

    snap = _map_tensors(tree, copy)
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record()
    return snap, event


class AsyncCheckpointer:
    """Background-thread checkpoint writer (``async_checkpointing: true``).

    ``save``/``save_many`` snapshot the state (see the module docstring)
    and queue it; one worker thread waits for the snapshot's copies,
    encodes it once and writes it atomically to every path given, in
    submission order, so a reader never sees a torn file and the stamp
    written last lands after the files before it.  A failed write is
    kept and raised by the next :meth:`poll` (the loop calls it once per
    epoch, inside its error envelope), by :meth:`wait` or by
    :meth:`close`.
    """

    def __init__(self):
        # bounded: a worker lagging many epochs behind would otherwise pin
        # that many snapshots in host memory; a full queue back-pressures
        # the epoch loop instead
        self._queue: queue.Queue = queue.Queue(maxsize=8)
        self._errors: list = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mst-checkpoint")
        self._thread.start()

    def _worker(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            paths, tree, event = item
            blob = None
            for path in paths:
                try:
                    if blob is None:  # wait and encode once per submission
                        if event is not None:
                            event.synchronize()
                        blob = encode_state(tree)
                    write_bytes_atomic(path, blob)
                except Exception as exc:  # noqa: BLE001 - raised by poll()
                    with self._lock:
                        self._errors.append((path, exc))
            del tree, item
            self._queue.task_done()

    def save(self, path: str, state) -> None:
        self.save_many([path], state)

    def save_many(self, paths, state) -> None:
        """One submission writing the same state to every path in *paths*
        (an epoch's last/best/epoch-tagged model files): snapshot once,
        encode once, write each."""
        paths = list(paths)
        for path in paths:
            _check_suffix(path)
        snap, event = _snapshot(state)
        self._queue.put((paths, snap, event))

    def _raise_errors(self) -> None:
        with self._lock:
            errors, self._errors = self._errors, []
        if not errors:
            return
        detail = "; ".join(f"{path}: {err!r}" for path, err in errors)
        raise RuntimeError(
            f"{len(errors)} async checkpoint write(s) failed: {detail}"
        ) from errors[0][1]

    def poll(self) -> None:
        """Raise the background errors so far, without blocking."""
        self._raise_errors()

    def wait(self) -> None:
        """Block until every submitted write is on disk; raise every
        accumulated background error."""
        self._queue.join()
        self._raise_errors()

    def close(self) -> None:
        self._queue.put(None)
        self.wait()  # the join covers the sentinel too (FIFO queue)
        self._thread.join(timeout=60)
