"""Checkpoints in the JAX package's on-disk format, the counterpart of
``repro/checkpoint/io.py``: either package reads what the other writes.

Two formats over one flat-key encoding of a tree (``_flatten``: ``//``
between levels, ``#i`` for a tuple entry, ``@field`` for a NamedTuple
field):

* **flat**: ``arrays.npz`` and ``manifest.json`` (``save``/``restore``);
* **sharded**: ``shard_00000.npz`` ... and a manifest that records every
  key's shape, dtype and shard and the run's topology (worker count,
  round, rule, policy, comm-state keys) (``save_sharded``/
  ``restore_sharded``/``saved_topology``). Keys are bin-packed over the
  shards by byte size, as JAX packs them. The manifest is written to a
  temporary file and renamed, so a save cut short leaves no torn
  manifest.

Under a device mesh (``AsyncCheckpointer.save(mesh=, row_keys=)``; a rank
holds its shard's rows of the worker-stacked keys) every rank writes its
own shards, as JAX's ``save_sharded(process_index=)`` has each process
write: shard ``s`` belongs to rank ``s % S``, which receives the rows of
its keys one key at a time (``shardmap_agg.gather_rows_to``) on the
caller's thread, every rank in the same order; the writer thread writes
only this rank's files, rank 0 the manifest, which records the global
``(w, ...)`` shapes; over a ``"model"`` axis only its index 0 writes.
The files are the meshless ``save_sharded`` ones with ``n_shards`` = S
(the default under a mesh). ``restore(rows=)``
reads a rank's rows of the worker-stacked keys alone: the members are
stored uncompressed, so a row range is one byte range of its file.

The ``.npz`` members are ``.npy`` files, written and read here without
``np.save``/``np.load``: numpy knows ``bfloat16`` only through
``ml_dtypes``, which the card's machine does not have. A bfloat16 leaf is
stored as its raw 16-bit payload under the descr ``'bfloat16'``, which
numpy with ``ml_dtypes`` (the JAX package's side) reads as bfloat16. On
reading, that descr and the two-byte void that numpy writes for an
``ml_dtypes`` bfloat16 array (JAX's files) are both bfloat16 payloads.

A Python int leaf (the port's host-side ``TrainState.step``) is stored as
the 0-d int32 that JAX keeps its round counter in, and restored into an
int leaf as an int.

Restores check structure and dtype as JAX does: a stored array that
disagrees with its manifest entry is corruption; a manifest dtype other
than the restore target's raises unless ``allow_cast=True``.

``AsyncCheckpointer`` copies the tree on its device and returns; a
thread copies the snapshot to the host and writes it while the next
rounds run, and ``wait`` raises a save that failed (under a mesh after a
barrier over the worker group, so that every rank's files are on disk
when any rank's ``wait`` returns).
"""
from __future__ import annotations

import ast
import io
import json
import os
import queue
import struct
import threading
import time
import zipfile
from typing import Any, Dict, FrozenSet, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

SEP = "//"

SHARDED_FORMAT = "wasgd-sharded-v1"

BF16 = "bfloat16"
_MAGIC = b"\x93NUMPY"


def _flatten(tree, prefix=""):
    """Flat key -> leaf, with the JAX package's keys."""
    def key(k):
        return f"{prefix}{SEP}{k}" if prefix else str(k)

    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, key(k)))
    elif hasattr(tree, "_fields"):          # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), key(f"@{k}")))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, key(f"#{i}")))
    else:
        out[prefix] = tree
    return out


# -- leaves <-> .npy members ------------------------------------------------

def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, int):
        return "int32"
    return str(np.asarray(leaf).dtype)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (host payload, dtype name); a bfloat16 payload is its
    16-bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        return t.numpy(), _dtype_name(t)
    dt = _dtype_name(leaf)
    return np.asarray(leaf, dtype=dt), dt


def _nbytes(leaf) -> int:
    """Bytes of a leaf's host payload, without copying it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return _host(leaf)[0].nbytes


def _npy_header(descr: str, shape) -> bytes:
    """A version 1.0 ``.npy`` header, padded as numpy pads it."""
    head = ("{'descr': %r, 'fortran_order': False, 'shape': %r, }"
            % (descr, tuple(int(n) for n in shape)))
    head += " " * (-(len(head) + 11) % 64) + "\n"
    return _MAGIC + b"\x01\x00" + struct.pack("<H", len(head)) + \
        head.encode("latin1")


def _write_npz(file: str, flat: Dict[str, Tuple[np.ndarray, str]]) -> None:
    with zipfile.ZipFile(file, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for k, (a, dt) in flat.items():
            descr = dt if dt == BF16 else np.lib.format.dtype_to_descr(
                a.dtype)
            with z.open(k + ".npy", "w", force_zip64=True) as f:
                f.write(_npy_header(descr, a.shape))
                f.write(memoryview(np.ascontiguousarray(a).reshape(-1)
                                   .view(np.uint8)))


def _read_npy(f, rows: Optional[Tuple[int, int]] = None
              ) -> Tuple[np.ndarray, str]:
    """One ``.npy`` member -> (payload, stored dtype name); ``rows=(lo,
    hi)`` reads rows ``lo:hi`` of the leading dim alone, seeking past the
    others."""
    magic = f.read(8)
    if magic[:6] != _MAGIC:
        raise ValueError("not an .npy member")
    major = magic[6]
    n = struct.unpack("<H" if major == 1 else "<I",
                      f.read(2 if major == 1 else 4))[0]
    head = ast.literal_eval(f.read(n).decode("utf8" if major >= 3
                                             else "latin1"))
    descr, shape = head["descr"], tuple(head["shape"])
    if descr == BF16 or (isinstance(descr, str)
                         and descr.lstrip("<>|=") == "V2"):
        dt, name = np.dtype(np.int16), BF16
    else:
        dt = np.dtype(descr)
        if dt.hasobject:
            raise ValueError(f"object arrays are not read: {descr!r}")
        name = str(dt)
    if rows is not None and not head["fortran_order"]:
        per_row = int(np.prod(shape[1:], dtype=np.int64))
        f.seek(rows[0] * per_row * dt.itemsize, os.SEEK_CUR)
        shape = (rows[1] - rows[0],) + shape[1:]
        if isinstance(f, io.BufferedReader):      # a file: no extra copy
            a = np.fromfile(f, dtype=dt, count=shape[0] * per_row)
        else:
            a = np.frombuffer(bytearray(f.read(shape[0] * per_row
                                               * dt.itemsize)), dtype=dt)
        return a.reshape(shape), name
    a = np.frombuffer(bytearray(f.read()), dtype=dt)
    a = a.reshape(shape, order="F" if head["fortran_order"] else "C")
    return (a if rows is None else a[rows[0]:rows[1]]), name


class _Npz:
    """Members of an ``.npz`` by key, read when asked for."""

    def __init__(self, path: str):
        self._path = path
        self._z = zipfile.ZipFile(path)

    def __getitem__(self, key: str) -> Tuple[np.ndarray, str]:
        with self._z.open(key + ".npy") as f:
            return _read_npy(f)

    def rows(self, key: str, lo: int, hi: int) -> Tuple[np.ndarray, str]:
        """Rows ``lo:hi`` of a member. An uncompressed member is read from
        the file at its offset (after the local header's 30 bytes, the
        name and the extra field), a compressed one whole."""
        info = self._z.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with self._z.open(info) as f:
                return _read_npy(f, rows=(lo, hi))
        with open(self._path, "rb") as f:
            f.seek(info.header_offset)
            head = f.read(30)
            if head[:4] != b"PK\x03\x04":
                raise ValueError(f"{self._path}: no local header for {key}")
            n_name, n_extra = struct.unpack("<HH", head[26:30])
            f.seek(n_name + n_extra, os.SEEK_CUR)
            return _read_npy(f, rows=(lo, hi))

    def reader(self):
        """``read(key, lo_hi)`` over this file: the key's rows ``lo:hi``,
        or all of it for None."""
        return lambda k, lo_hi: self[k] if lo_hi is None \
            else self.rows(k, *lo_hi)

    def close(self):
        self._z.close()


# -- restore checks -----------------------------------------------------------

def _check_structure(like_keys, stored_keys):
    """Keys the target expects but the checkpoint lacks, and keys the
    checkpoint holds that the target has no slot for."""
    missing = sorted(set(like_keys) - set(stored_keys))
    unexpected = sorted(set(stored_keys) - set(like_keys))
    if missing or unexpected:
        parts = []
        if missing:
            parts.append(f"missing from checkpoint: {missing[:8]}"
                         + (f" (+{len(missing) - 8} more)"
                            if len(missing) > 8 else ""))
        if unexpected:
            parts.append(f"unexpected in checkpoint: {unexpected[:8]}"
                         + (f" (+{len(unexpected) - 8} more)"
                            if len(unexpected) > 8 else ""))
        raise ValueError("checkpoint structure mismatch: " + "; ".join(parts))


def _check_leaf(key: str, stored: Tuple[np.ndarray, str], entry: Dict,
                like_leaf, allow_cast: bool):
    """Shape and dtype checks for one restored leaf, as JAX's: a stored
    dtype other than its manifest entry is corruption; a manifest dtype
    other than the target's raises unless ``allow_cast``. The leaf comes
    back on the target's device (an int target: an int)."""
    arr, stored_dtype = stored
    like_shape = (tuple(like_leaf.shape) if isinstance(like_leaf, torch.Tensor)
                  else np.shape(like_leaf))
    if tuple(arr.shape) != tuple(like_shape):
        raise ValueError(f"shape mismatch for {key}: "
                         f"{tuple(arr.shape)} vs {like_shape}")
    man_dtype = entry.get("dtype")
    if man_dtype is not None and stored_dtype != man_dtype:
        raise ValueError(
            f"checkpoint corruption for {key}: stored dtype {stored_dtype} "
            f"disagrees with its manifest entry {man_dtype}")
    like_dtype = _dtype_name(like_leaf)
    if man_dtype is not None and man_dtype != like_dtype and not allow_cast:
        raise ValueError(
            f"dtype mismatch for {key}: checkpoint holds {man_dtype}, "
            f"restore target expects {like_dtype}; pass allow_cast=True to "
            f"cast explicitly")
    t = torch.from_numpy(arr)
    if stored_dtype == BF16:
        t = t.view(torch.bfloat16)
    target = like_dtype if allow_cast else (man_dtype or stored_dtype)
    if isinstance(like_leaf, torch.Tensor):
        return t.to(device=like_leaf.device, dtype=getattr(torch, target))
    if isinstance(like_leaf, int):
        return int(t)
    return t.to(getattr(torch, target))


class Rows(NamedTuple):
    """A reader's rows of the worker-stacked keys: each key of ``keys`` is
    a ``(p, ...)`` array of which the reader keeps rows ``rows`` (a
    rank's under a mesh, ``shardmap_agg.local_rows``)."""
    keys: FrozenSet[str]
    p: int
    rows: slice


def _restore_flat(data_of_key, manifest: Dict, like: Any, allow_cast: bool,
                  rows: Optional[Rows] = None):
    """Rebuilds ``like``'s structure leaf by leaf along ``_flatten``'s
    traversal. ``data_of_key(k, lo_hi)`` reads a key, rows ``lo:hi`` of
    it or all of it for None; with ``rows`` its keys are read that way."""
    _check_structure(_flatten(like), manifest["keys"])

    def read(k):
        if rows is None or k not in rows.keys:
            return data_of_key(k, None)
        shape = manifest["keys"][k]["shape"]
        if not shape or shape[0] != rows.p:
            raise ValueError(
                f"shape mismatch for {k}: checkpoint holds {tuple(shape)}, "
                f"a ({rows.p}, ...) worker-stacked array expected")
        return data_of_key(k, (rows.rows.start, rows.rows.stop))

    def build(sub, prefix=""):
        def key(k):
            return f"{prefix}{SEP}{k}" if prefix else str(k)

        if isinstance(sub, dict):
            return {k: build(v, key(k)) for k, v in sub.items()}
        if hasattr(sub, "_fields"):         # NamedTuple
            return type(sub)(*(build(getattr(sub, k), key(f"@{k}"))
                               for k in sub._fields))
        if isinstance(sub, (tuple, list)):
            return type(sub)(build(v, key(f"#{i}"))
                             for i, v in enumerate(sub))
        return _check_leaf(prefix, read(prefix),
                           manifest["keys"][prefix], sub, allow_cast)

    return build(like)


# -- flat format ----------------------------------------------------------------

def save(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = {k: _host(v) for k, v in _flatten(tree).items()}
    _write_npz(os.path.join(path, "arrays.npz"), flat)
    _write_manifest(path, {
        "keys": {k: {"shape": list(a.shape), "dtype": dt}
                 for k, (a, dt) in flat.items()},
        "meta": meta or {},
    })


def restore(path: str, like: Any, allow_cast: bool = False,
            rows: Optional[Rows] = None) -> Tuple[Any, Dict]:
    """Restores into the structure of ``like`` (checked by
    ``_check_leaf``). A sharded checkpoint at ``path`` goes to
    ``restore_sharded``. With ``rows``, ``like`` holds those rows of its
    worker-stacked keys, and only they are read."""
    manifest = _read_manifest(path)
    if manifest.get("format") == SHARDED_FORMAT:
        return restore_sharded(path, like, allow_cast=allow_cast, rows=rows)
    data = _Npz(os.path.join(path, "arrays.npz"))
    try:
        tree = _restore_flat(data.reader(), manifest, like, allow_cast, rows)
    finally:
        data.close()
    return tree, manifest["meta"]


# -- sharded format ---------------------------------------------------------------

def _write_manifest(path: str, manifest: Dict) -> None:
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, "manifest.json"))


def _read_manifest(path: str) -> Dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _shard_file(s: int) -> str:
    return f"shard_{s:05d}.npz"


def _assign_shards(nbytes: Dict[str, int], n_shards: int) -> List[List[str]]:
    """Keys in descending size (ties by key), each to the lightest shard
    (ties by index): JAX's assignment."""
    bins: List[List[str]] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for k in sorted(nbytes, key=lambda k: (-nbytes[k], k)):
        s = min(range(n_shards), key=lambda i: (loads[i], i))
        bins[s].append(k)
        loads[s] += nbytes[k]
    return bins


def _entry(leaf, row_shards: int = 1) -> Tuple[Tuple[int, ...], str, int]:
    """A leaf's manifest shape and dtype name, and its bytes; a leaf of
    which this rank holds one of ``row_shards`` equal row blocks counts
    them all."""
    if isinstance(leaf, torch.Tensor):
        shape = tuple(leaf.shape)
        if row_shards > 1:
            shape = (shape[0] * row_shards,) + shape[1:]
        return shape, _dtype_name(leaf), _nbytes(leaf) * row_shards
    a, dt = _host(leaf)
    return tuple(a.shape), dt, a.nbytes


def _manifest(entries: Dict, bins: List[List[str]],
              topology: Optional[Dict], meta: Optional[Dict]) -> Dict:
    return {
        "format": SHARDED_FORMAT,
        "n_shards": len(bins),
        "keys": {k: {"shape": list(entries[k][0]), "dtype": entries[k][1],
                     "shard": s}
                 for s, keys in enumerate(bins) for k in keys},
        "topology": topology or {},
        "meta": meta or {},
    }


def _write_shards(path: str, flat: Dict, bins: List[List[str]],
                  shards) -> None:
    for s in shards:
        _write_npz(os.path.join(path, _shard_file(s)),
                   {k: _host(flat[k]) for k in bins[s]})


def save_sharded(path: str, tree: Any, meta: Optional[Dict] = None,
                 topology: Optional[Dict] = None,
                 n_shards: Optional[int] = None) -> None:
    """``n_shards`` (default 1) shard files and the manifest with
    ``topology`` (``{"p", "round", "rule", "policy", "comm_state"}``)."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    entries = {k: _entry(v) for k, v in flat.items()}
    bins = _assign_shards({k: e[2] for k, e in entries.items()},
                          max(1, n_shards or 1))
    _write_shards(path, flat, bins, range(len(bins)))
    _write_manifest(path, _manifest(entries, bins, topology, meta))


class MeshSave(NamedTuple):
    """What a rank writes of a save under a mesh: the bins, the shards it
    owns, and on rank 0 the manifest."""
    bins: List[List[str]]
    shards: List[int]
    manifest: Optional[Dict]


def gather_for_save(tree: Any, mesh, row_keys: FrozenSet[str],
                    n_shards: Optional[int] = None,
                    meta: Optional[Dict] = None,
                    topology: Optional[Dict] = None
                    ) -> Tuple[Dict[str, Any], MeshSave]:
    """The collective half of a save under a mesh; every rank runs it, in
    the same order. ``tree`` is this rank's: the leaves of ``row_keys``
    (flat keys) its worker rows, the others the same on every rank. Keys
    are bin-packed by their global bytes over ``n_shards`` (default S)
    shards; shard ``s`` belongs to rank ``s % S``, which receives every
    rank's rows of each of its row keys, one key at a time. Returns this
    rank's keys (whole arrays, new tensors on the device) and its part.
    Over a mesh axis other than the worker axes (``"model"``) only the
    ranks at its index 0 gather and write; the others' worker groups
    hold the same rows and write nothing."""
    from repro_torch.core import shardmap_agg as smagg
    n_ranks = smagg.mesh_worker_shards(mesh)
    me = smagg.shard_index(mesh)
    flat = _flatten(tree)
    entries = {k: _entry(v, n_ranks if k in row_keys else 1)
               for k, v in flat.items()}
    bins = _assign_shards({k: e[2] for k, e in entries.items()},
                          max(1, n_shards or n_ranks))
    mine: Dict[str, Any] = {}
    if smagg.replica_index(mesh) != 0:
        return mine, MeshSave(bins, [], None)
    for s, keys in enumerate(bins):
        owner = s % n_ranks
        for k in keys:
            v = flat[k]
            if k in row_keys:
                full = smagg.gather_rows_to(v, owner, mesh)
                if full is not None:
                    mine[k] = full
            elif owner == me:
                mine[k] = (v.detach().clone() if isinstance(v, torch.Tensor)
                           else v)
    return mine, MeshSave(
        bins, [s for s in range(len(bins)) if s % n_ranks == me],
        _manifest(entries, bins, topology, meta) if me == 0 else None)


def restore_sharded(path: str, like: Any, allow_cast: bool = False,
                    rows: Optional[Rows] = None) -> Tuple[Any, Dict]:
    """Restores a sharded checkpoint into the structure of ``like``, which
    must have the checkpoint's shapes (its worker count: see
    ``saved_topology``), or with ``rows`` those rows of its worker-stacked
    keys."""
    manifest = _read_manifest(path)
    if manifest.get("format") != SHARDED_FORMAT:
        raise ValueError(
            f"{path} is not a sharded checkpoint "
            f"(format={manifest.get('format')!r}); use restore()")
    shards: Dict[int, _Npz] = {}

    def data_of_key(k, lo_hi):
        s = manifest["keys"][k]["shard"]
        if s not in shards:
            shards[s] = _Npz(os.path.join(path, _shard_file(s)))
        return shards[s].reader()(k, lo_hi)

    try:
        tree = _restore_flat(data_of_key, manifest, like, allow_cast, rows)
    finally:
        for z in shards.values():
            z.close()
    return tree, manifest["meta"]


def saved_topology(path: str) -> Dict:
    """A checkpoint's format, shard count, topology (``{}`` for a flat
    one) and meta, read from its manifest alone."""
    manifest = _read_manifest(path)
    return {"format": manifest.get("format", "flat"),
            "n_shards": manifest.get("n_shards", 1),
            "topology": manifest.get("topology", {}),
            "meta": manifest.get("meta", {})}


# -- background saves -------------------------------------------------------------

class AsyncCheckpointer:
    """Sharded saves on a writer thread.

    ``save`` copies every tensor of the tree on its device (the copy is
    queued on the device before any later round can replace the state)
    and returns. The thread copies the snapshot to the host and writes
    the shards and the manifest. A failed save is raised by the next
    ``save`` or ``wait``. The thread starts at a ``save`` and ends at
    ``wait``: none is left idle to outlive the caller's process group
    and to race the interpreter's exit.

    ``save(mesh=, row_keys=)`` saves a tree of which this rank holds its
    rows of ``row_keys``: the gathers (``gather_for_save``) run on the
    caller's thread, in the same order on every rank, since a collective
    from the writer thread would race the training's; the thread writes
    this rank's shards (on rank 0 the manifest too) from what they
    brought, and ``wait`` ends in a barrier over the worker group."""

    def __init__(self, depth: int = 2, telemetry=None):
        """``telemetry`` (a ``repro_torch.obs`` sink, optional) receives a
        ``CheckpointSave`` for each completed save, its duration taken on
        the writer thread (the copy to the host and the writes). Callers'
        threads set the attribute; the writer only reads it."""
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._exc: Optional[Exception] = None
        self._exc_lock = threading.Lock()
        self.telemetry = telemetry
        self._mesh = None                 # set by a save under a mesh
        self._thread = self._new_writer()  # started by the first save

    def _new_writer(self) -> threading.Thread:
        return threading.Thread(target=self._worker, daemon=True,
                                name="ckpt-writer")

    def _worker(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                self._write(*job)
            except Exception as e:       # raised on the caller's thread
                with self._exc_lock:
                    self._exc = e
            finally:
                # the job holds the snapshot on the device: drop it now,
                # not when the next job replaces it
                job = None
                self._q.task_done()

    def _write(self, path, snap, meta, topology, n_shards, part):
        t0 = time.perf_counter()
        if part is None:
            save_sharded(path, snap, meta=meta, topology=topology,
                         n_shards=n_shards)
        else:
            os.makedirs(path, exist_ok=True)
            _write_shards(path, snap, part.bins, part.shards)
            if part.manifest is not None:
                _write_manifest(path, part.manifest)
        tele = self.telemetry
        if tele is not None and getattr(tele, "enabled", False):
            from repro_torch.obs.events import CheckpointSave
            tele.emit(CheckpointSave(
                path=path, round=int((meta or {}).get("round", -1)),
                duration_s=time.perf_counter() - t0,
                nbytes=sum(_nbytes(v) for v in snap.values())))

    def _raise_pending(self):
        with self._exc_lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            raise RuntimeError("async checkpoint save failed") from exc

    def save(self, path: str, tree: Any, meta: Optional[Dict] = None,
             topology: Optional[Dict] = None,
             n_shards: Optional[int] = None, mesh=None,
             row_keys: FrozenSet[str] = frozenset()) -> None:
        if mesh is None:
            self._raise_pending()
            snap = {k: v.detach().clone() if isinstance(v, torch.Tensor)
                    else v for k, v in _flatten(tree).items()}
            part = None
        else:
            self._mesh = mesh
            snap, part = gather_for_save(tree, mesh, row_keys,
                                         n_shards=n_shards, meta=meta,
                                         topology=topology)
            self._raise_pending()     # after the collectives every rank runs
        if not self._thread.is_alive():
            self._thread = self._new_writer()
            self._thread.start()
        self._q.put((path, snap, meta, topology, n_shards, part))

    def wait(self):
        """Blocks until every queued save is on disk and the writer
        thread has ended; raises a failure. After a save under a mesh,
        every rank's shards are on disk when any rank's ``wait``
        returns."""
        self._q.join()
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        if self._mesh is not None:
            # the writers (the replica at index 0) wait for each other, and
            # then every replica for its writer
            import torch.distributed as dist
            from repro_torch.core import shardmap_agg as smagg
            dist.barrier(group=smagg.worker_group(self._mesh))
            replicas = smagg.replica_group(self._mesh)
            if replicas is not None:
                dist.barrier(group=replicas)
        self._raise_pending()

    def close(self):
        self.wait()
