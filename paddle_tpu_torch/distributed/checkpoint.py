"""Atomic CRC-checked checkpoints (the layer serving hot-swap stands on).

Counterpart of `paddle_tpu/distributed/checkpoint.py`, in the same file
format, so a snapshot either package saves loads into the other:

  - a state tree flattens in the reference's tree order: dict keys sorted,
    lists and tuples in order (an `(int8, scales)` pair is two leaves);
    None is an empty subtree
  - leaf i is `leaf_{i}.npy`; a bf16 tensor is written as numpy writes a
    bfloat16 array (descr '<V2': the raw two bytes of each value), every
    other leaf as `np.save` writes it
  - `manifest.json` carries the leaf count, the step, the tree structure
    (`PyTreeDef(...)`, the reference's string) and one CRC32 per leaf over
    the leaf's bytes

Atomicity, as in the reference: every save writes into a sibling
`<path>.tmp-*` directory, leaf by leaf, then a fsynced `manifest.json`,
then commits with a directory rename. A crash before the rename leaves a
torn temp dir and the previous checkpoint intact; while an existing save is
replaced, it survives as `<path>.old-*`, which readers take as the
committed checkpoint until the swap completes. `load_state` verifies every
CRC (CheckpointCorruptError on a mismatch); `load_latest` walks a run
directory newest-first and returns the first valid save.

Fault points (paddle_tpu_torch.failsafe): `ckpt.write_leaf` (per leaf,
detail "leaf {i}") and `ckpt.commit` (between the temp write and the
rename). `install_preemption_hook` flushes pending async saves (plus an
optional final save) on SIGTERM.

`save_model_and_optimizer` / `load_model_and_optimizer` need the
optimizer's `state_dict`, which is not ported (ROADMAP A9.1): they raise
NotImplementedError.
"""
import glob
import json
import os
import shutil
import signal
import threading
import uuid
import zlib

import numpy as np
import torch

from ..failsafe import fault_point

MANIFEST = "manifest.json"
_LEGACY_INDEX = "index.json"      # pre-atomic saves: no checksums
_BF16_DESCR = "<V2"               # numpy's descr of a bfloat16 array


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory that cannot be trusted: missing manifest,
    missing leaves, or checksum mismatch (torn/bit-rotted write)."""


# -- tree order (the reference's pytree flattening) ----------------------------
def _flatten(state):
    """(leaves, structure) of a state tree in the reference's order: dict
    keys sorted, lists and tuples in order, None an empty subtree. The
    structure is a nested description _unflatten rebuilds from, and its
    str() is the reference's `PyTreeDef(...)` string."""
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", keys, [walk(x[k]) for k in keys])
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, None, [walk(v) for v in x])
        if x is None:
            return ("none", None, [])
        leaves.append(x)
        return ("leaf", None, [])

    return leaves, _TreeDef(walk(state))


class _TreeDef:
    __slots__ = ("node",)

    def __init__(self, node):
        self.node = node

    def __eq__(self, other):
        return isinstance(other, _TreeDef) and self.node == other.node

    def __str__(self):
        def fmt(node):
            kind, keys, kids = node
            if kind == "leaf":
                return "*"
            if kind == "none":
                return "None"
            if kind == "dict":
                return "{" + ", ".join(f"{k!r}: {fmt(c)}"
                                       for k, c in zip(keys, kids)) + "}"
            inner = ", ".join(fmt(c) for c in kids)
            if kind == "list":
                return f"[{inner}]"
            return f"({inner},)" if len(kids) == 1 else f"({inner})"
        return f"PyTreeDef({fmt(self.node)})"


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(node):
        kind, keys, kids = node
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, kids)}
        vals = [build(c) for c in kids]
        return vals if kind == "list" else tuple(vals)

    return build(treedef.node)


def tree_leaves(state):
    return _flatten(state)[0]


def tree_structure(state):
    return _flatten(state)[1]


# -- leaves on disk ------------------------------------------------------------
def _to_host(leaf):
    """A leaf as a host numpy array; a bf16 tensor as the uint16 view of
    its bytes (numpy has no bfloat16)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(leaf), False


def _checksum(arr):
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _save_leaf(path, arr, bf16):
    if not bf16:
        np.save(path, arr)
        return
    # numpy writes a bfloat16 array with descr '<V2'; the same header and
    # bytes make the file the reference's
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _atomic_write(host_leaves, treedef, path, step):
    """Write leaves + manifest into a temp sibling, then rename-commit.
    host_leaves: [(numpy array, is_bf16)]."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    try:
        checksums = []
        for i, (arr, bf16) in enumerate(host_leaves):
            fault_point("ckpt.write_leaf", detail=f"leaf {i}")
            _save_leaf(os.path.join(tmp, f"leaf_{i}.npy"), arr, bf16)
            checksums.append(_checksum(arr))
        manifest = {"format": 1, "n_leaves": len(host_leaves),
                    "step": step, "treedef": str(treedef),
                    "checksums": checksums}
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # the torn-save window: temp dir complete, final name not yet
        # committed — a crash here must leave the previous save intact
        fault_point("ckpt.commit")
        if os.path.exists(path):
            # a directory replace is not one atomic rename on POSIX: the
            # previous save survives the window as `<path>.old-*`
            old = f"{path}.old-{uuid.uuid4().hex[:8]}"
            os.rename(path, old)
            try:
                os.rename(tmp, path)
            except BaseException:
                os.rename(old, path)     # restore the previous save
                raise
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
    except BaseException:
        # the temp dir is garbage on any failure (load_latest skips
        # *.tmp-* names too)
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_state(state, path, step=None):
    """Synchronous save of a tree of tensors / arrays. Atomic: readers see
    the previous checkpoint or the new one, never a torn mix."""
    leaves, treedef = _flatten(state)
    _atomic_write([_to_host(leaf) for leaf in leaves], treedef, path, step)


_pending = []
_async_errors = []


def save_state_async(state, path, step=None):
    """Device->host copy now; atomic disk write in a background thread.
    Writer failures are queued and re-raised by wait_until_finished()."""
    leaves, treedef = _flatten(state)
    host_leaves = [_to_host(leaf) for leaf in leaves]

    def writer():
        try:
            _atomic_write(host_leaves, treedef, path, step)
        except BaseException as e:   # noqa: BLE001 — carried to waiters
            _async_errors.append(e)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_until_finished():
    """Join every pending async save; re-raise the first writer error
    (all pending state is cleared either way)."""
    for t in _pending:
        t.join()
    _pending.clear()
    if _async_errors:
        err = _async_errors[0]
        _async_errors.clear()
        raise err


def _resolve_dir(path):
    """A hard crash inside the replace-existing swap can leave the
    committed save parked at `<path>.old-*` with `path` itself gone;
    readers fall back to the newest such survivor."""
    if os.path.isdir(path):
        return path
    survivors = glob.glob(path + ".old-*")
    if survivors:
        return max(survivors, key=os.path.getmtime)
    return path


def _read_manifest(path):
    mpath = os.path.join(path, MANIFEST)
    legacy = os.path.join(path, _LEGACY_INDEX)
    try:
        if os.path.exists(mpath):
            with open(mpath) as f:
                return json.load(f)
        with open(legacy) as f:        # pre-atomic layout: no checksums
            return json.load(f)
    except FileNotFoundError:
        raise CheckpointCorruptError(
            f"no {MANIFEST} (or legacy {_LEGACY_INDEX}) under {path!r} — "
            "not a committed checkpoint")
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint manifest under {path!r}: {e}")


def _place(arr, tgt):
    """A loaded leaf placed like the target leaf: a tensor of the target's
    dtype on its device (a '<V2' bf16 leaf read as the bf16 it holds), an
    array as itself."""
    if not torch.is_tensor(tgt):
        return np.asarray(arr)
    a = np.ascontiguousarray(arr)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=tgt.device, dtype=tgt.dtype)


def load_state(path, like=None, verify=True):
    """Restore a tree saved by save_state. Without `like`: (leaves,
    manifest) as host arrays. With `like`: (tree, manifest), the tree in
    like's structure, each leaf placed like like's (see _place).
    verify=True (default) checks every leaf against the manifest's CRC32
    and raises CheckpointCorruptError on torn/corrupt data."""
    path = _resolve_dir(path)
    index = _read_manifest(path)
    checksums = index.get("checksums")
    leaves = []
    for i in range(index["n_leaves"]):
        leaf_path = os.path.join(path, f"leaf_{i}.npy")
        try:
            arr = np.load(leaf_path)
        except (FileNotFoundError, OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"checkpoint {path!r} is torn: leaf {i} of "
                f"{index['n_leaves']} unreadable ({e})")
        if verify and checksums is not None:
            got = _checksum(arr)
            if got != checksums[i]:
                raise CheckpointCorruptError(
                    f"checkpoint {path!r} leaf {i} checksum mismatch: "
                    f"manifest {checksums[i]:#010x}, file {got:#010x} "
                    "(torn or bit-rotted write)")
        leaves.append(arr)
    if like is None:
        return leaves, index
    like_leaves, treedef = _flatten(like)
    if len(like_leaves) != len(leaves):
        raise CheckpointCorruptError(
            f"checkpoint has {len(leaves)} leaves, target "
            f"{len(like_leaves)}")
    placed = [_place(a, t) for a, t in zip(leaves, like_leaves)]
    return _unflatten(treedef, placed), index


# -- engine-facing snapshot load/verify (serving weight hot-swap) ----------
def save_snapshot(weights, path, step=None):
    """Atomic CRC32-manifest save of a serving-engine weight tree — the
    artifact `load_snapshot_for` verifies before a hot-swap flip."""
    save_state(weights, path, step=step)


def load_snapshot_for(like, path):
    """Load a weight snapshot and verify it is installable into the engine
    tree `like`: per-leaf CRC32, tree structure (leaf count) and per-leaf
    shape, all checked before anything is handed to the engine, so a bad
    artifact fails the swap while the old weights still serve. Returns the
    placed tree (fresh tensors, nothing of `like` is written)."""
    state, _ = load_state(path, like=like, verify=True)
    got = tree_leaves(state)
    want = tree_leaves(like)
    for i, (g, w) in enumerate(zip(got, want)):
        if tuple(np.shape(g)) != tuple(np.shape(w)):
            raise CheckpointCorruptError(
                f"snapshot {path!r} leaf {i} shape {tuple(np.shape(g))} "
                f"does not match the serving engine's "
                f"{tuple(np.shape(w))} — wrong model geometry for this "
                "engine")
    return state


# -- step-directory layout (resume picks the latest VALID save) ------------
def step_dir(root, step):
    return os.path.join(root, f"step_{int(step):08d}")


def save_checkpoint(state, root, step, async_=False):
    """Save under root/step_NNNNNNNN (atomic). async_=True returns the
    writer thread (wait_until_finished() to flush)."""
    path = step_dir(root, step)
    if async_:
        return save_state_async(state, path, step=step)
    save_state(state, path, step=step)
    return path


def available_steps(root):
    """Committed step numbers under root, ascending. Torn temp dirs
    (*.tmp-*) and stray names are excluded; validity is not checked here
    (load_latest does that)."""
    if not os.path.isdir(root):
        return []
    steps = set()
    for name in os.listdir(root):
        if ".tmp-" in name or not name.startswith("step_"):
            continue
        # a step parked at step_N.old-* (crash mid-swap) still counts
        base = name.split(".old-")[0]
        try:
            steps.add(int(base[len("step_"):]))
        except ValueError:
            continue
    return sorted(steps)


def load_latest(root, like=None, verify=True):
    """Restore the newest valid checkpoint under root, skipping torn or
    corrupt saves. Raises FileNotFoundError when nothing valid survives."""
    skipped = []
    for step in reversed(available_steps(root)):
        path = step_dir(root, step)
        try:
            return load_state(path, like=like, verify=verify)
        except CheckpointCorruptError as e:
            skipped.append((step, str(e)))
            continue
    detail = "".join(f"\n  step {s}: {m}" for s, m in skipped)
    raise FileNotFoundError(
        f"no valid checkpoint under {root!r}"
        + (f" ({len(skipped)} corrupt save(s) skipped):{detail}"
           if skipped else ""))


# -- preemption ------------------------------------------------------------
_preempt = {"installed": False, "callback": None, "signum": None}


def flush_on_preemption():
    """Drain pending async saves, then run the installed final-save
    callback (if any). Idempotent; safe to call directly."""
    try:
        wait_until_finished()
    finally:
        cb = _preempt["callback"]
        if cb is not None:
            cb()


def _preemption_handler(signum, frame):
    try:
        flush_on_preemption()
    finally:
        # a preempted process must terminate even if the flush re-raised
        raise SystemExit(128 + signum)


def install_preemption_hook(callback=None, signum=signal.SIGTERM):
    """Flush pending async writes (and run `callback()`) when the process
    receives `signum`. Returns True if the handler was installed, False off
    the main thread."""
    _preempt["callback"] = callback
    if _preempt["installed"] and _preempt["signum"] == signum:
        return True
    try:
        signal.signal(signum, _preemption_handler)
    except ValueError:          # not the main thread
        return False
    _preempt["installed"] = True
    _preempt["signum"] = signum
    return True


def save_model_and_optimizer(model, optimizer, path, step=None):
    raise NotImplementedError(
        "save_model_and_optimizer needs the optimizer state_dict, which is "
        "not ported to paddle_tpu_torch yet (ROADMAP A9.1)")


def load_model_and_optimizer(model, optimizer, path):
    raise NotImplementedError(
        "load_model_and_optimizer needs the optimizer state_dict, which is "
        "not ported to paddle_tpu_torch yet (ROADMAP A9.1)")
