"""Async, integrity-checked checkpointing (port of
``repro.train.checkpoint``).

Layout of a checkpoint directory, the reference's::

    <dir>/step_00000100/
        shard-00000.npz      # this process's arrays
        manifest.json        # step, extra, each key's shape, dtype, SHA-1
        COMMITTED            # written last: presence = checkpoint is valid

A state is a nested dict whose leaves are tensors, numpy arrays or Python
numbers; a key is its path joined by ``/`` (the trainer saves
``params/<name>``, ``opt/m/<name>``, ``opt/v/<name>`` and ``opt/step``).

* atomic commit — the writer fills ``step_N.tmp`` and renames it; readers
  trust only directories holding ``COMMITTED``.
* snapshot before return — ``save`` copies every tensor to the host before
  it returns (on the CPU an explicit copy: ``Tensor.cpu()`` would return
  the live storage, which the next optimizer step changes in place). A
  device tensor goes into a pinned host buffer that the manager keeps for
  the next save (``save`` first waits for the write that reads it), so the
  copy runs at the link's rate and allocates nothing on the device.
* async — with ``async_=True`` the hashing and writing run in a background
  thread; ``wait()`` joins it, and every ``save`` waits for the one before.
* dtypes numpy lacks — a bf16 tensor is stored as its bits (an int16 view)
  under its torch dtype name in the manifest, and round-trips bit for bit.
  Its SHA-1 is that of its bytes, as the reference's is.
* restore in place — ``restore`` reads each array of the shard straight
  into host memory and verifies every checksum first (an ``IOError`` on a
  mismatch or an unreadable shard leaves the live state untouched), then
  copies
  into the tensors of the given state under ``no_grad`` and returns them,
  so the model's modules keep training the parameters they hold and the
  device holds no second copy.
* retention — the ``keep`` most recent checkpoints are kept.

The process index and count are 0 and 1 unless ``torch.distributed`` is
initialised; each process writes its own shard and process 0 the manifest.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_HASH_THREADS = min(8, os.cpu_count() or 1)


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype)


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NUMPY_DTYPES = (torch.float64, torch.float32, torch.float16, torch.int64,
                 torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for a dtype numpy lacks (bf16 ...) a view of its
    bits as an integer of the same width."""
    return t if t.dtype in _NUMPY_DTYPES else t.view(_BITS[t.element_size()])


def _read_stored(fh, zf: zipfile.ZipFile, key: str) -> np.ndarray:
    """Array ``key`` of an npz, read with one copy from the file: an
    uncompressed member's bytes straight into the array (the zip layer's
    CRC is not checked; the manifest's SHA-1 is), else through numpy."""
    fmt = np.lib.format
    info = zf.getinfo(f"{key}.npy")
    header = None
    if info.compress_type == zipfile.ZIP_STORED:
        fh.seek(info.header_offset)
        head = fh.read(30)
        if head[:4] != b"PK\x03\x04":
            raise zipfile.BadZipFile(f"no local header for {key}")
        name_len, extra_len = struct.unpack("<HH", head[26:30])
        fh.seek(info.header_offset + 30 + name_len + extra_len)
        read_header = {(1, 0): fmt.read_array_header_1_0,
                       (2, 0): fmt.read_array_header_2_0}.get(
                           fmt.read_magic(fh))
        header = read_header(fh) if read_header else None
    if header is None:  # compressed, or a header version numpy reads alone
        with zf.open(info) as member:
            return fmt.read_array(member)
    shape, fortran, dtype = header
    if fortran:
        shape = shape[::-1]
    a = np.empty(shape, dtype)
    if fh.readinto(memoryview(a.reshape(-1)).cast("B")) != a.nbytes:
        raise EOFError(f"{key} is truncated")
    return a.T if fortran else a


def _sha1(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a)).hexdigest()


def _process() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.process_index, self.process_count = _process()
        self._pinned: Dict[str, torch.Tensor] = {}  # host side of snapshots
        # seconds and bytes of each save and restore, for reports
        self.save_stats: list = []
        self.restore_stats: list = []

    # -- discovery -----------------------------------------------------------

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "COMMITTED"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------------

    def _snapshot(self, tree) -> Tuple[dict, dict]:
        """(key -> host array that nothing else writes, key -> manifest
        dtype name)."""
        flat = _flatten(tree)
        host, pinned = {}, {}
        for k, v in flat.items():
            if not isinstance(v, torch.Tensor):
                host[k] = np.array(v, copy=True)
                continue
            t = _bits(v.detach())
            if t.is_cuda:
                buf = self._pinned.get(k)
                if buf is None or buf.shape != t.shape \
                        or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                pinned[k] = buf.copy_(t, non_blocking=True)
                host[k] = buf.numpy()
            else:
                host[k] = t.clone().contiguous().numpy()
        if pinned:
            torch.cuda.synchronize()
        self._pinned = pinned
        return host, {k: _dtype_name(v) for k, v in flat.items()}

    def _write(self, step: int, host: dict, dtypes: dict, extra: dict,
               stats: dict):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(_HASH_THREADS) as pool:
            sha = dict(zip(host, pool.map(_sha1, host.values())))
        t1 = time.perf_counter()
        np.savez(os.path.join(tmp, f"shard-{self.process_index:05d}.npz"),
                 **host)
        if self.process_index == 0:
            manifest = {
                "step": step,
                "extra": extra,
                "keys": {k: {"shape": list(v.shape), "dtype": dtypes[k],
                             "sha1": sha[k]} for k, v in host.items()},
                "process_count": self.process_count,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.save_stats.append(dict(stats, step=step, hash_s=t1 - t0,
                                    write_s=time.perf_counter() - t1))

    def _write_async(self, *args):
        try:
            self._write(*args)
        except Exception as e:  # raised again by wait()
            self._error = e

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree, extra: Optional[dict] = None,
             async_: bool = False):
        """Snapshot ``tree`` to the host (done when this returns), then
        hash and write it, in a background thread with ``async_``."""
        self.wait()
        t0 = time.perf_counter()
        host, dtypes = self._snapshot(tree)
        stats = dict(snapshot_s=time.perf_counter() - t0,
                     bytes=sum(a.nbytes for a in host.values()))
        args = (step, host, dtypes, extra or {}, stats)
        if async_:
            self._thread = threading.Thread(target=self._write_async,
                                            args=args)
            self._thread.start()
        else:
            self._write(*args)

    def wait(self):
        """Join the background write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore -------------------------------------------------------------

    def restore(self, step: Optional[int], like) -> Tuple[dict, dict]:
        """(tree, extra) of checkpoint ``step`` (the latest when None).
        ``like`` is the live state: every checksum is verified first (an
        ``IOError`` on a mismatch), then each tensor of ``like`` receives
        its saved value in place and is returned; other leaves come back
        as saved (a Python number as a Python number)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        t0 = time.perf_counter()
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        host, sha = {}, {}
        shard = os.path.join(d, f"shard-{self.process_index:05d}.npz")
        with open(shard, "rb") as fh, zipfile.ZipFile(fh) as zf, \
                ThreadPoolExecutor(_HASH_THREADS) as pool:
            for k in manifest["keys"]:
                try:
                    host[k] = _read_stored(fh, zf, k)
                except (zipfile.BadZipFile, ValueError, KeyError,
                        EOFError) as e:
                    raise IOError(f"unreadable {k} in step {step}: {e}") \
                        from e
                sha[k] = pool.submit(_sha1, host[k])
            for k, meta in manifest["keys"].items():
                if sha[k].result() != meta["sha1"]:
                    raise IOError(f"checksum mismatch for {k} in step {step}")
        t1 = time.perf_counter()
        flat = _flatten(like)
        missing = [k for k in flat if k not in host]
        if missing:
            raise KeyError(f"step {step} lacks {missing[:4]}")
        out = {}
        with torch.no_grad():
            for k, v in flat.items():
                a = host[k]
                if isinstance(v, torch.Tensor):
                    if tuple(a.shape) != tuple(v.shape) \
                            or manifest["keys"][k]["dtype"] != _dtype_name(v):
                        raise ValueError(
                            f"{k}: saved {tuple(a.shape)} "
                            f"{manifest['keys'][k]['dtype']}, live "
                            f"{tuple(v.shape)} {_dtype_name(v)}")
                    src = torch.from_numpy(a)
                    if src.dtype != v.dtype:
                        src = src.view(v.dtype)  # the bits of a bf16 etc.
                    v.copy_(src)
                    out[k] = v
                elif isinstance(v, (int, float, bool)):
                    out[k] = type(v)(a.item())
                else:
                    out[k] = a
        if any(isinstance(v, torch.Tensor) and v.is_cuda
               for v in flat.values()):
            torch.cuda.synchronize()
        self.restore_stats.append(dict(
            step=step, read_hash_s=t1 - t0, copy_s=time.perf_counter() - t1,
            bytes=sum(a.nbytes for a in host.values())))
        return _unflatten(like, out), manifest.get("extra", {})


def _unflatten(like, flat: dict, prefix: str = ""):
    return {k: _unflatten(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in like.items()}
