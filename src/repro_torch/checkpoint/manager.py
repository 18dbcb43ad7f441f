"""Checkpointing: atomic, async, verified, keep-k, layout-independent
(twin of ``repro/checkpoint/manager.py``).

Layout: ``<dir>/step_<n>/`` holding ``manifest.json`` (leaf paths, shapes,
dtypes, per-array SHA-256 checksums) and ``arrays.npz``. Leaves are
tensors of the train state (stored as host numpy) or Python scalars (the
step and the Adam count).

* Writes are atomic: a tmp dir, fsync of the arrays, the manifest and the
  tmp dir, ``os.replace``, fsync of the parent. A crash at any point
  leaves the old checkpoint or the new one, never a torn directory.
* A transient ``OSError`` during a write is retried with backoff.
* ``save_async`` copies to the host synchronously and writes on a thread;
  a failure there re-raises on ``wait()`` or the next ``save_async``.
* The SHA-256 checksums are taken on a pool of threads, one array each
  (``hashlib`` releases the GIL), over the arrays' own buffers; on save
  they run while the archive is written. A restore reads its arrays on
  such a pool too.
* ``restore`` verifies the checksums (``verify=True``), raises
  :class:`CheckpointCorruptError` on a mismatch or an unreadable file,
  and :meth:`restore_latest_valid` walks back to the newest checkpoint
  that restores cleanly.
* Dtypes are never converted. numpy has no bfloat16, so a bf16 tensor is
  stored by this rule: its raw 16-bit patterns as int16, with
  ``torch.bfloat16`` in the manifest, and viewed back on restore. A
  target whose dtype differs from the stored one raises.
* ``restore`` copies into the target's tensors in place (on their device,
  keeping ``requires_grad``) and returns the target's structure with its
  scalar leaves replaced.

Layouts. A checkpoint holds the state as one device would: the params
(replicated on every rank of a DP×SP layout) and, under ZeRO-1, the full
padded flat moments, which :func:`gather_zero1` assembles from the data
ranks' slices (one all-gather each of ``m`` and ``v``, tag
``ckpt.zero1_gather``, on save steps only) before rank 0 writes. On
restore every rank reads the files and copies out its own slice
(``restore(..., shards=zero1_shards(state, layout))``). So a checkpoint
written at (dp, sp) restores at any (dp, sp′), and one written at (1, sp)
or without ZeRO-1 restores on one device and the other way round; a
ZeRO-1 degree change that alters the padded length raises ``ValueError``
(a shape), one that alters the state's tree (flat moments against a
tree of moments) raises :class:`CheckpointError` (missing paths), as the
reference raises in the same cases.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import primitives
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.optim.adamw import Zero1AdamState

MANIFEST_VERSION = 2
_SCALARS = (int, float, bool)


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or restored."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint directory exists but its contents are unreadable or
    fail checksum verification."""


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype)
    if isinstance(leaf, _SCALARS):
        return type(leaf).__name__
    raise TypeError(f"checkpoint leaf of type {type(leaf).__name__}: want a "
                    f"tensor or an int, float or bool")


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)          # raw bits; see module doc
        return t.numpy()
    return np.asarray(leaf)


def _host_tree(tree):
    flat = leaves_with_paths(tree)
    return (["/".join(p) for p, _ in flat], [_to_host(l) for _, l in flat],
            [_dtype_name(l) for _, l in flat])


def _sha256(arr: np.ndarray) -> str:
    """The digest of the array's C-order bytes (no copy of a contiguous
    array)."""
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(memoryview(raw)).hexdigest()


_IO_THREADS = min(8, os.cpu_count() or 1)


def _checksums_async(arrays):
    """Start the arrays' SHA-256 digests on a thread pool; returns a
    function that waits for them (in order) and shuts the pool down."""
    pool = ThreadPoolExecutor(max_workers=_IO_THREADS)
    futures = [pool.submit(_sha256, a) for a in arrays]

    def result():
        try:
            return [f.result() for f in futures]
        finally:
            pool.shutdown()
    return result


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, *,
                 verify: bool = True, retries: int = 3,
                 backoff_s: float = 0.05):
        self.dir = directory
        self.keep = keep
        self.verify = verify
        self.retries = retries
        self.backoff_s = backoff_s
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._savez = np.savez   # seam for fault injection in tests

    # -- write --------------------------------------------------------------

    def save(self, step: int, tree: Any):
        self._write_with_retry(step, *_host_tree(tree))

    def save_async(self, step: int, tree: Any):
        """The device→host copy happens now (so a later in-place update
        cannot race it); the disk write runs on a thread. An exception of
        the previous async write re-raises here or on ``wait()``."""
        host = _host_tree(tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._write_safe, args=(step, *host), daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight async write; re-raise its exception if it
        failed (the error is cleared, so a later save can proceed)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_safe(self, step, paths, arrays, dtypes):
        try:
            self._write_with_retry(step, paths, arrays, dtypes)
        except BaseException as e:    # surfaced by wait()/next save_async
            self._error = e

    def _write_with_retry(self, step, paths, arrays, dtypes):
        for attempt in range(self.retries + 1):
            try:
                return self._write(step, paths, arrays, dtypes)
            except OSError:
                if attempt >= self.retries:
                    raise
                time.sleep(self.backoff_s * (2 ** attempt))

    def _write(self, step, paths, arrays, dtypes):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        checksums = _checksums_async(arrays)
        try:
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                self._savez(f, **{f"a{i}": a for i, a in enumerate(arrays)})
                f.flush()
                os.fsync(f.fileno())
        finally:
            digests = checksums()
        manifest = {
            "format_version": MANIFEST_VERSION,
            "step": step,
            "n_leaves": len(arrays),
            "paths": list(paths),
            "shapes": [list(a.shape) for a in arrays],
            "dtypes": list(dtypes),
            "checksums": digests,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self.dir)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read ---------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_manifest(self, path: str) -> dict:
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            raise CheckpointCorruptError(
                f"{path}: manifest.json is missing (interrupted write or "
                "damage); restore an older step or delete this directory")
        try:
            with open(mpath) as f:
                return json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            raise CheckpointCorruptError(
                f"{path}: manifest.json is unreadable ({e}); restore an "
                "older step or delete this directory") from e

    def _load_arrays(self, path: str, indices) -> dict:
        """``{i: array a<i>}`` of the archive, for the given indices only
        (a subtree restore reads only its own leaves), read on a pool of
        threads, each through its own handle on the archive."""
        apath = os.path.join(path, "arrays.npz")
        if not os.path.exists(apath):
            raise CheckpointCorruptError(
                f"{path}: arrays.npz is missing (interrupted write); "
                "restore an older step or delete this directory")
        def load(i):
            with np.load(apath) as data:
                return np.asarray(data[f"a{i}"])

        try:
            with ThreadPoolExecutor(max_workers=_IO_THREADS) as pool:
                return dict(zip(indices, pool.map(load, indices)))
        except (zipfile.BadZipFile, KeyError, ValueError, EOFError,
                OSError) as e:
            raise CheckpointCorruptError(
                f"{path}: arrays.npz is unreadable ({type(e).__name__}: "
                f"{e}); restore an older step or delete this directory"
            ) from e

    def restore(self, step: int, target_tree: Any, *,
                verify: Optional[bool] = None,
                shards: Optional[Dict[str, Tuple[int, int]]] = None):
        """Restore into the structure of ``target_tree`` (a subtree of the
        saved state is fine: leaves are matched by path). Every check
        (paths, shapes, dtypes, checksums) runs before the first copy.

        ``shards``: leaf path (``"opt/m"``) → ``(index, n_shards)`` for a
        target leaf that holds one slice of a stored 1-d array: the stored
        length must be ``n_shards`` times the target's, and slice
        ``index`` is copied (:func:`zero1_shards`)."""
        shards = shards or {}
        verify = self.verify if verify is None else verify
        path = os.path.join(self.dir, f"step_{step:08d}")
        if not os.path.isdir(path):
            raise CheckpointError(
                f"no checkpoint for step {step} under {self.dir} "
                f"(available steps: {self.all_steps() or 'none'})")
        manifest = self._read_manifest(path)
        index = {p: i for i, p in enumerate(manifest["paths"])}
        flat = leaves_with_paths(target_tree)
        names = ["/".join(p) for p, _ in flat]
        missing = [n for n in names if n not in index]
        if missing:
            raise CheckpointError(
                f"{path}: target leaves {missing[:4]} not in the checkpoint "
                f"(it holds {len(index)} leaves) — the target tree does not "
                "match what was saved")
        order = [index[n] for n in names]
        arrays = self._load_arrays(path, order)
        if verify:
            digests = _checksums_async([arrays[i] for i in order])()
            bad = [n for n, i, d in zip(names, order, digests)
                   if d != manifest["checksums"][i]]
            if bad:
                raise CheckpointCorruptError(
                    f"{path}: SHA-256 checksum mismatch for {len(bad)} "
                    f"array(s): {bad[:4]} — on-disk corruption; restore an "
                    "older step (restore_latest_valid)")
        for n, i, (_, want) in zip(names, order, flat):
            got = tuple(arrays[i].shape)
            shape = tuple(want.shape) if isinstance(want, torch.Tensor) \
                else ()
            if n in shards:
                shape = (shape[0] * shards[n][1],)
            if got != shape:
                raise ValueError(f"checkpoint shape {got} != target {shape} "
                                 f"at {n}")
            if manifest["dtypes"][i] != _dtype_name(want):
                raise ValueError(
                    f"checkpoint dtype {manifest['dtypes'][i]} != target "
                    f"{_dtype_name(want)} at {n}: dtypes are never "
                    "converted on restore")
        loaded = []
        with torch.no_grad():
            for n, i, (_, want) in zip(names, order, flat):
                arr = arrays[i]
                if n in shards:
                    size = want.shape[0]
                    arr = arr[shards[n][0] * size:(shards[n][0] + 1) * size]
                if isinstance(want, torch.Tensor):
                    # (ascontiguousarray makes a 0-d array 1-d)
                    src = torch.from_numpy(
                        np.ascontiguousarray(arr).reshape(arr.shape))
                    if want.dtype == torch.bfloat16:
                        src = src.view(torch.bfloat16)
                    want.copy_(src)
                    loaded.append(want)
                else:
                    loaded.append(type(want)(arr.item()))
        it = iter(loaded)
        return tree_map(lambda _: next(it), target_tree)

    def restore_latest_valid(self, target_tree: Any, *, shards=None):
        """Walk checkpoints newest-first and restore the first valid one
        (checksums verified). Returns ``(step, tree, rejected)`` with
        ``rejected = [(step, reason), ...]`` for every newer one that
        failed; raises :class:`CheckpointError` when none restores."""
        steps = self.all_steps()
        rejected = []
        for step in reversed(steps):
            try:
                tree = self.restore(step, target_tree, verify=True,
                                    shards=shards)
                return step, tree, rejected
            except (CheckpointError, ValueError) as e:
                rejected.append((step, f"{type(e).__name__}: {e}"))
        raise CheckpointError(
            f"no valid checkpoint under {self.dir} "
            f"(tried {list(reversed(steps)) or 'none'}; "
            f"rejections: {[r[0] for r in rejected]})")


# ---------------------------------------------------------------------------
# Layouts: ZeRO-1's moment slices in and out of a checkpoint.
# ---------------------------------------------------------------------------

def _sharded_opt(state, layout) -> bool:
    return (layout is not None and layout.zero_degree > 1
            and isinstance(state.get("opt"), Zero1AdamState))


def gather_zero1(state, layout):
    """The train state as a checkpoint holds it: under a layout with ZeRO-1
    the zero group's moment slices (the dp·tp ranks of this sequence
    index, the data group at tp 1) are gathered into the full padded flat
    ``m`` and ``v`` (one all-gather each over the zero group, tag
    ``ckpt.zero1_gather``; every rank must call this); otherwise
    ``state`` itself."""
    if not _sharded_opt(state, layout):
        return state
    opt = state["opt"]
    with torch.no_grad():
        full = [primitives.allgather_states(
            x, layout.zero_group, gather_axis=0, tiled=True,
            tag="ckpt.zero1_gather") for x in (opt.m, opt.v)]
    return {**state, "opt": Zero1AdamState(full[0], full[1], opt.count)}


def zero1_shards(state, layout) -> Dict[str, Tuple[int, int]]:
    """``restore``'s ``shards`` for this rank under ``layout``: its zero
    index's slice (``d·tp + m`` of dp·tp) of the stored flat moments under
    ZeRO-1, else none."""
    if not _sharded_opt(state, layout):
        return {}
    return {path: (layout.zero_index, layout.zero_degree)
            for path in ("opt/m", "opt/v")}
