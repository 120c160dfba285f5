"""Atomic, async checkpointing of dict trees of tensors (the reference's
``src/repro/checkpoint/manager.py``).

Layout (one directory per step):
    ckpt_dir/step_000123.tmp/        # written first
        meta.json                    # tree structure, shapes, dtypes, step
        shard_0.npz                  # every leaf's raw bytes
    ckpt_dir/step_000123/            # atomic rename when complete

Fault-tolerance properties:
  * atomicity — a crash mid-write leaves only a .tmp dir, never a
    half-valid checkpoint; restore picks the newest complete dir;
  * async — the serialize+write runs on a background thread, so the
    train loop only blocks on the device->host copy;
  * self-describing — meta.json carries the tree definition, each leaf's
    shape and its torch dtype's name.

Leaves are saved as raw bytes and re-viewed on restore, so bf16 and f8
leaves cross numpy bit for bit without a numpy bfloat16 type. Restore
puts each leaf on the device of the matching leaf of ``like``, or, with
``placements``, re-shards it onto a mesh (elastic restore onto another
mesh layout, the reference's ``shardings=``).

Sharded trees: a DTensor leaf is gathered whole (every rank takes part)
and rank 0 of the default process group writes; such a save is always
synchronous and ends at a barrier, so every rank can restore from the
directory as soon as it returns. Whether
a checkpoint written by the reference package restores here is not
promised: its dtype names and leaf order may agree, but nothing tests
it.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..tree import flatten, flatten_up_to, unflatten


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a leaf (a DTensor gathered whole first): a
    snapshot even where the leaf is on the CPU already."""
    if _is_dtensor(t):
        t = t.full_tensor()
    return torch.as_tensor(t).detach().to("cpu", copy=True)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _raw(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint names an unknown dtype {name!r}")
    return dt


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False):
        """Snapshot ``tree`` (params/opt_state/any tree of tensors) at
        step."""
        self.wait()  # one in-flight save at a time
        leaves, treedef = flatten(tree)
        sharded = any(_is_dtensor(l) for l in leaves)
        # device->host copy happens here (synchronous, consistent snapshot)
        host_leaves = [_host(l) for l in leaves]
        if sharded and _rank() != 0:        # rank 0 writes the gathered tree
            torch.distributed.barrier()
            return
        meta = {
            "step": step,
            "treedef": str(treedef),
            "shapes": [list(l.shape) for l in host_leaves],
            "dtypes": [str(l.dtype).replace("torch.", "")
                       for l in host_leaves],
            "time": time.time(),
        }

        def write():
            try:
                tmp = self.dir / f"step_{step:08d}.tmp"
                final = self.dir / f"step_{step:08d}"
                if final.exists():
                    return  # idempotent: this step is already durable
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                (tmp / "meta.json").write_text(json.dumps(meta))
                np.savez(tmp / "shard_0.npz",
                         **{f"leaf_{i}": _raw(l)
                            for i, l in enumerate(host_leaves)})
                tmp.rename(final)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking or sharded:
            write()
            if sharded:
                torch.distributed.barrier()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e}") from e

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") \
                    and not p.name.endswith(".tmp"):
                out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None,
                placements: Any = None):
        """Load a checkpoint (the latest by default) into the structure
        of ``like``, each leaf on the device of ``like``'s leaf.
        ``placements`` (a tree of ``sharding.specs.Layout`` matching
        ``like``, or one Layout for every leaf) re-shards each leaf onto
        its layout's mesh instead, whatever mesh saved it. Returns
        (step, tree), or (None, None) when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        if like is None:
            raise ValueError("restore requires `like` for the tree "
                             "definition")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "meta.json").read_text())
        like_leaves, treedef = flatten(like)
        if len(like_leaves) != len(meta["shapes"]):
            raise ValueError(f"checkpoint {d} holds {len(meta['shapes'])} "
                             f"leaves, `like` has {len(like_leaves)}")
        from ..sharding.specs import Layout, distribute
        if placements is None:
            layouts = [None] * len(like_leaves)
        elif isinstance(placements, Layout):
            layouts = [placements] * len(like_leaves)
        else:
            layouts = flatten_up_to(treedef, placements)
        leaves = []
        with np.load(d / "shard_0.npz") as data:
            for i, (ref, lay) in enumerate(zip(like_leaves, layouts)):
                raw = torch.from_numpy(data[f"leaf_{i}"].copy())
                t = raw.view(_dtype(meta["dtypes"][i])) \
                    .reshape(meta["shapes"][i])
                if lay is None:
                    leaves.append(t.to(torch.as_tensor(ref).device))
                else:                      # each rank keeps its own slice
                    leaves.append(distribute(t.to(lay.mesh.device_type),
                                             lay))
        return step, unflatten(treedef, leaves)
