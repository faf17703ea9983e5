"""Restart-safe checkpoints of training state, with elastic restore.

The port of the JAX package's ``ckpt/checkpoint.py``, in its format:

    <dir>/step_00000400/
        manifest.json       # step, extra (the data cursor), and per leaf
                            # its shape, dtype, crc32 and process
        shard_00000.npz     # the leaves under their flat names ("a/b/c")
        COMMIT              # written last: a step without it is ignored

* **atomic**: a step is written into ``step_XXXXXXXX.tmp`` and renamed
  once ``COMMIT`` is in it, so a crash mid-save never touches the latest
  good step;
* **async**: :class:`CheckpointManager.save` copies the leaves to host
  memory, then writes them on a background thread; the loop waits only
  for the copy;
* **self-validating**: a crc32 per leaf in the manifest, checked on
  restore;
* **retention**: the manager keeps the last ``keep`` committed steps.

bf16 leaves go into the npz as their 16-bit patterns, int16 (numpy has no
bf16) and keep ``"bfloat16"`` as their manifest dtype; their crc32 is
over those bytes, the same bytes as the JAX package's bf16 arrays.
Restore puts each leaf on the device and in the dtype of the matching
leaf of ``like``.

Under a mesh (``rt`` with its spec tree ``specs``) a state's leaves are
the rank's shards: saving gathers each leaf whole (a collective, on
every rank), rank 0 writes the step as above, and the other ranks wait
for it at a barrier; the files are the one-process files.  Restoring
reads each whole leaf and keeps the rank's slice under ``specs``, which
may belong to another mesh than the one that saved (**elastic**: a job
restarted on another number of ranks continues).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..dist.sharding import tree_map_specs

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager",
           "latest_step"]


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, name + "/"))
        else:
            flat[name] = v
    return flat


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype) of a leaf; bf16 as its int16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        x = x.numpy()
    a = np.asarray(x)
    return a, str(a.dtype)


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def _committed_steps(base: str):
    for d in os.listdir(base):
        if d.startswith("step_") and d[5:].isdigit() and \
                os.path.exists(os.path.join(base, d, "COMMIT")):
            yield int(d[5:])


def latest_step(base: str) -> Optional[int]:
    """The newest committed step under ``base``, or None."""
    if not os.path.isdir(base):
        return None
    steps = list(_committed_steps(base))
    return max(steps) if steps else None


def _on_mesh(rt) -> bool:
    return rt is not None and rt.mesh is not None


def _host_state(state, rt=None, specs=None
                ) -> Dict[str, Tuple[np.ndarray, str]]:
    """Host copies of the leaves; under a mesh each gathered whole (on
    every rank) first."""
    if _on_mesh(rt):
        state = tree_map_specs(rt.gather, state, specs)
    return {name: _to_numpy(x) for name, x in _flatten(state).items()}


def _writer(rt) -> bool:
    """Whether this process writes: rank 0 under a mesh, else always."""
    import torch.distributed as dist
    return not _on_mesh(rt) or dist.get_rank() == 0


def _barrier(rt) -> None:
    if _on_mesh(rt):
        import torch.distributed as dist
        dist.barrier()


def save_checkpoint(base: str, step: int, state: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None, *, rt=None,
                    specs=None) -> str:
    """Write one atomic checkpoint of ``state`` (nested dicts of tensors or
    arrays; under ``rt``'s mesh the rank's shards under ``specs``, on
    every rank); returns its directory."""
    host = _host_state(state, rt, specs)
    try:
        if _writer(rt):
            _write(base, step, host, extra)
    finally:
        _barrier(rt)
    return _step_dir(base, step)


def _write(base, step, host, extra) -> str:
    """The files of one step, as process 0 of the JAX package's format."""
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": {
            name: {"shape": list(a.shape), "dtype": dt,
                   "crc32": zlib.crc32(np.ascontiguousarray(a).tobytes()),
                   "proc": 0}
            for name, (a, dt) in host.items()
        },
    }
    np.savez(os.path.join(tmp, "shard_00000.npz"),
             **{name: a for name, (a, _) in host.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore_checkpoint(base: str, like: Dict[str, Any],
                       step: Optional[int] = None, *, rt=None, specs=None,
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(state, extra)`` of step ``step`` (the latest committed one by
    default) in the structure of ``like``, each leaf on the device and in
    the dtype of ``like``'s; under ``rt``'s mesh each leaf is the rank's
    slice under ``specs`` (``like`` holds the shards).  Raises
    ``FileNotFoundError`` without a committed step, ``IOError`` on a
    checksum mismatch and ``ValueError`` on a shape mismatch."""
    mesh = _on_mesh(rt)
    if step is None:
        step = latest_step(base)
        if mesh:   # every rank restores the step rank 0 found
            import torch.distributed as dist
            box = [step]
            dist.broadcast_object_list(box, src=0)
            step = box[0]
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat: Dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(d)):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(d, fn)) as z:
                for k in z.files:
                    flat[k] = z[k]
    for name, meta in manifest["leaves"].items():
        crc = zlib.crc32(np.ascontiguousarray(flat[name]).tobytes())
        if crc != meta["crc32"]:
            raise IOError(f"checksum mismatch for {name} at step {step}")

    spec_of = dict(_flatten(specs)) if mesh else {}

    def leaf(name, ref):
        t = torch.from_numpy(np.array(flat[name]))
        if manifest["leaves"][name]["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if mesh:
            t = rt.local(t, spec_of[name]).clone()
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)}, "
                             f"expected {tuple(ref.shape)}")
        if isinstance(ref, torch.Tensor):
            return t.to(device=ref.device, dtype=ref.dtype)
        return t.numpy().astype(np.asarray(ref).dtype)

    def rebuild(tree, prefix=""):
        return {k: (rebuild(v, f"{prefix}{k}/") if isinstance(v, dict)
                    else leaf(f"{prefix}{k}", v))
                for k, v in tree.items()}

    return rebuild(like), manifest["extra"]


class CheckpointManager:
    """Asynchronous writer, retention policy and restart cursor.  Under
    ``rt``'s mesh every rank calls :meth:`save` and :meth:`wait` at the
    same steps, with the state's spec tree; rank 0 writes."""

    def __init__(self, base: str, keep: int = 3, rt=None):
        self.base = base
        self.keep = keep
        self.rt = rt
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False
        os.makedirs(base, exist_ok=True)

    def wait(self) -> None:
        """Wait for the last save (under a mesh: every rank, at a barrier
        after rank 0's write); raise what its writer raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier(self.rt)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None, specs=None) -> None:
        """Device-to-host copy now (under a mesh the gather of every
        leaf); the disk write on a background thread of rank 0."""
        self.wait()
        host = _host_state(state, self.rt, specs)
        self._pending = True
        if not _writer(self.rt):
            return

        def work():
            try:
                _write(self.base, step, host, extra)
                self._gc()
            except Exception as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def restore_latest(self, like, step: Optional[int] = None, specs=None):
        return restore_checkpoint(self.base, like, step, rt=self.rt,
                                  specs=specs)

    def _gc(self) -> None:
        for s in sorted(_committed_steps(self.base))[:-self.keep]:
            shutil.rmtree(_step_dir(self.base, s), ignore_errors=True)
