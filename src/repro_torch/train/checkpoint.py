"""Fault-tolerant checkpointing: atomic, resumable, restorable onto any
device.

Counterpart of the reference's ``train/checkpoint.py``, with its layout and
guarantees (one directory per step):

    <root>/step_000123/
        manifest.json        # step, extra, tree fingerprint, leaf shapes
        shard_<i>.npz        # leaf arrays (host copies)
    <root>/LATEST            # atomically-renamed pointer file

Writes go to ``step_<n>.tmp`` and are renamed only after every shard and
the manifest are fsynced, so a crash mid-save never corrupts the latest
checkpoint; the ``keep`` newest steps are kept.  A tree is nested dicts,
lists and tuples of tensors (or numpy arrays), and an ``nn.Module`` stands
for its ``state_dict`` (``repro_torch.utils.tree``).  numpy has no bf16:
a bf16 leaf is stored as its raw 16-bit pattern, with ``bfloat16`` as its
dtype in the manifest, and restored bit for bit.

``save_async`` copies every leaf to host memory before it returns (the
port's training step updates its tensors in place, so a later copy would
catch the next step's values) and writes in a worker thread.  ``restore``
takes ``device=`` (leaves go to that device, or to the target leaf's
own) and, as the reference, ``shardings=``: a tree of
``distributed.sharding.NamedSharding`` matching the target, over any mesh,
so a checkpoint saved on 8 ranks restores onto 4 (elastic reshard).  A
module in the target receives the values in place.

A ``DTensor`` leaf (a sharded model or optimizer state) is gathered whole
for the save, on every rank of its mesh (a collective), and only rank 0
of the world writes; ``save`` returns once the write is visible to every
rank.  A ``DTensor`` target leaf is restored with its own placements
unless ``shardings`` names others; each rank keeps its block of the
saved array.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.parallel import is_dtensor
from repro_torch.utils.tree import children, flatten_names


def _tree_structure_fingerprint(tree: Any) -> str:
    names = [n for n, _ in flatten_names(tree)]
    return hashlib.sha256("|".join(names).encode()).hexdigest()[:16]


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _writer() -> bool:
    """Whether this process writes: rank 0 of the world, or the process
    itself outside one."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _to_host(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates cannot reach;
    bf16 as its int16 bit pattern; a DTensor gathered whole."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.array(leaf, copy=True)


def _from_host(arr: np.ndarray, dtype: str, like: Any, device,
               sharding=None) -> Any:
    if not isinstance(like, torch.Tensor):
        return arr
    t = torch.from_numpy(np.array(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    if sharding is None and is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t.to(like.device), like.device_mesh,
                                 like.placements, src_data_rank=None)
    if sharding is not None:
        dm = sharding.mesh.device_mesh
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dm.device_type == "cuda" else torch.device("cpu"))
        return sharding.distribute(t.to(dev))
    return t.to(device if device is not None else like.device)


def _unflatten(target: Any, leaves: list, device) -> Any:
    """``target``'s structure holding ``leaves`` (in ``flatten_names``
    order); a module gets its values in place and is returned itself."""
    it = iter(leaves)

    def build(node):
        kids = children(node)
        if kids is None:
            return next(it)
        if isinstance(node, nn.Module):
            if device is not None:
                node.to(device)
            state = {key: build(sub) for key, sub in kids}
            with torch.no_grad():
                for key, tensor in node.state_dict(keep_vars=True).items():
                    tensor.copy_(state[key])
            return node
        if node is None:
            return None
        built = [(key, build(sub)) for key, sub in kids]
        if isinstance(node, (list, tuple)):
            return type(node)(v for _, v in built)
        return dict(built)

    return build(target)


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._async_thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None,
             leaves_per_shard: int = 64) -> pathlib.Path:
        host = self._host(tree)
        final = self.root / f"step_{step:09d}"
        if _writer():
            final = self._write(step, host, extra or {}, leaves_per_shard)
        _barrier()
        return final

    def save_async(self, step: int, tree: Any, *, extra: Optional[dict] = None
                   ) -> None:
        """Snapshot to host memory synchronously, write in a worker thread."""
        self.wait()
        host = self._host(tree)
        if not _writer():
            return

        def work():
            try:
                self._write(step, host, extra or {}, 64)
            except BaseException as e:  # noqa: BLE001
                self._async_error = e

        self._async_thread = threading.Thread(target=work, daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise err

    @staticmethod
    def _host(tree: Any) -> tuple:
        """(fingerprint, [(name, host array, dtype name)])."""
        return (_tree_structure_fingerprint(tree),
                [(name, _to_host(leaf), _dtype_name(leaf))
                 for name, leaf in flatten_names(tree)])

    def _write(self, step: int, host: tuple, extra: dict,
               leaves_per_shard: int) -> pathlib.Path:
        fingerprint, flat = host
        final = self.root / f"step_{step:09d}"
        tmp = self.root / f"step_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        shards = [flat[i:i + leaves_per_shard]
                  for i in range(0, len(flat), leaves_per_shard)]
        manifest = {
            "step": step,
            "extra": extra,
            "fingerprint": fingerprint,
            "time": time.time(),
            "leaves": {},
            "n_shards": len(shards),
        }
        for i, shard in enumerate(shards):
            arrays = {}
            for j, (name, leaf, dtype) in enumerate(shard):
                key = f"a{j}"
                arrays[key] = leaf
                manifest["leaves"][name] = {
                    "shard": i, "key": key, "shape": list(leaf.shape),
                    "dtype": dtype,
                }
            path = tmp / f"shard_{i}.npz"
            with open(path, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
        mpath = tmp / "manifest.json"
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._update_latest(final.name)
        self._gc()
        return final

    def _update_latest(self, name: str) -> None:
        tmp = self.root / "LATEST.tmp"
        tmp.write_text(name)
        tmp.rename(self.root / "LATEST")

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        ptr = self.root / "LATEST"
        if ptr.exists():
            name = ptr.read_text().strip()
            p = self.root / name
            if (p / "manifest.json").exists():
                return int(name.split("_")[1])
        steps = self.list_steps()  # fall back to a directory scan
        return steps[-1] if steps else None

    def restore(self, target_tree: Any, *, step: Optional[int] = None,
                device=None, shardings=None) -> tuple[Any, dict]:
        """Restore into the structure of ``target_tree``; tensor leaves go
        to ``device`` (default: each target leaf's device) with the saved
        dtype, so a checkpoint written on one device restores onto
        another.  ``shardings`` (a tree like the target's, of
        ``NamedSharding``) makes each leaf a DTensor over its mesh."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = self.root / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        if manifest["fingerprint"] != _tree_structure_fingerprint(target_tree):
            raise ValueError("checkpoint tree structure mismatch")
        cache: dict[int, Any] = {}
        placed = dict(flatten_names(shardings)) if shardings is not None \
            else {}

        leaves = []
        for name, leaf in flatten_names(target_tree):
            info = manifest["leaves"][name]
            shard = info["shard"]
            if shard not in cache:
                cache[shard] = np.load(d / f"shard_{shard}.npz")
            arr = cache[shard][info["key"]]
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch for {name}")
            leaves.append(_from_host(arr, info["dtype"], leaf, device,
                                     placed.get(name)))
        return _unflatten(target_tree, leaves, device), manifest["extra"]
