"""Distributed checkpoint and resume with agreement on the newest
common step (port of ``chainermn_tpu/extensions/checkpoint.py``;
ChainerMN's ``create_multi_node_checkpointer(name, comm)``).

Every rank snapshots its own state; at resume the ranks allgather their
inventories and load the newest step that all of them hold, so a job
restarted after a failure resumes where every rank can.  The storage is
ChainerMN's own model and the JAX package's per-rank npz tier, one
process per card:

* each rank writes ``<path>/<name>/rank_<r>/step_<NNNNNNNNNNNN>`` (no
  ``rank_<r>`` level in a world of one);
* the state's tensors, copied to the host, go into ``tensors.pt`` (one
  ``torch.save`` of a list: every dtype, bf16 included, bit for bit);
  the tree around them, with its other leaves (iterator positions,
  counters, numpy arrays), is pickled into ``tree.pkl``;
* ``manifest.json`` (``resilience.elastic``: world size, process count,
  byte count and sha256 of each file) is written inside the temporary
  directory, and the snapshot commits by renaming that directory, so a
  torn write is never a step; stale ``.tmp*`` and ``.old*`` directories
  of crashed saves are ignored by the step scan and swept on the next
  save;
* the inventory counts only steps whose files match their digests, so
  a flipped byte or a truncated file drops that step and the agreement
  falls back one step; the check is memoized by
  ``elastic.snapshot_signature``;
* the newest ``keep`` steps are kept, per rank.

``use_async=True`` copies the state to the host, returns, and writes on
one background thread; the commit stays atomic, an in-flight save is
simply not a step yet, and the next save, ``resume``,
``wait_until_finished`` and ``finalize`` wait for it (and raise its
error, if it failed).

The JAX package's other storage tier, orbax (``use_orbax=True``, one
logical checkpoint of global arrays), has no counterpart: PyTorch has no
orbax, and the port's state is per rank.  The port takes no such
option.  A resume in a world of another size raises
``WorldResizeRequiredError`` without a template, and
``NotImplementedError`` (``elastic.reshard_state``) with one.
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._tree import tree_map
from ..resilience import elastic
from ..resilience.errors import WorldResizeRequiredError
from ..resilience.log import emit
from ..resilience.retry import lockstep_allgather

TENSORS = "tensors.pt"
TREE = "tree.pkl"
_STEP = re.compile(r"step_(\d+)")
_STALE = re.compile(r"step_\d+\.(tmp|old)\d*")


class _TensorLeaf:
    """The place of the tree's ``index``-th tensor in ``tree.pkl``."""

    def __init__(self, index: int):
        self.index = index


def _to_host(tree):
    """A copy of ``tree`` that later training cannot change: tensors
    detached and copied to the CPU, numpy arrays copied."""
    def copy(leaf):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            return (leaf.to("cpu", copy=True) if leaf.device.type != "cpu"
                    else leaf.clone())
        if isinstance(leaf, np.ndarray):
            return leaf.copy()
        return leaf

    return tree_map(copy, tree)


def _flatten(tree, tensors: list):
    def take(leaf):
        if isinstance(leaf, torch.Tensor):
            tensors.append(leaf)
            return _TensorLeaf(len(tensors) - 1)
        return leaf

    return tree_map(take, tree)


def _unflatten(structure, tensors: list):
    return tree_map(lambda leaf: tensors[leaf.index]
                    if isinstance(leaf, _TensorLeaf) else leaf, structure)


def _onto(state, like):
    """``state`` with each tensor moved to the device of the tensor at
    the same place in ``like`` (where ``like`` has one)."""
    return tree_map(lambda leaf, other: leaf.to(other.device)
                    if isinstance(leaf, torch.Tensor)
                    and isinstance(other, torch.Tensor) else leaf,
                    state, like)


class _MultiNodeCheckpointer:
    """Trainer extension (``trainer.extend(ckpt)``), also usable alone
    through :meth:`save` and :meth:`resume`.

    It runs after the iteration's other extensions (priority -100, as
    Chainer's snapshot), so the trigger states it saves are the ones the
    uninterrupted run goes on with."""

    priority = -100
    name = "checkpointer"

    def __init__(self, name: str, comm, path: str = "checkpoints",
                 trigger=(1, "epoch"), keep: int = 3,
                 use_async: bool = False):
        self._comm = comm
        self._root = os.path.join(path, name)
        if comm.size > 1:
            # per-rank storage: a path on a shared filesystem never has
            # two ranks writing one snapshot
            self._root = os.path.join(self._root, f"rank_{comm.rank}")
        self.trigger = trigger
        self._keep = keep
        self._use_async = use_async
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        # path -> (stat signature, verified); a committed snapshot never
        # changes, so one full hash per directory state is enough
        self._verified: dict = {}
        os.makedirs(self._root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._root, f"step_{step:012d}")

    # -- save ----------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Snapshot ``state`` (a tree of tensors and picklable leaves) as
        ``step``.  With ``use_async`` the write runs in the background
        once the state is on the host."""
        self.wait_until_finished()  # back-to-back saves serialize
        host = _to_host(state)
        if not self._use_async:
            self._commit(step, host)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                1, thread_name_prefix="checkpoint-writer")
        self._pending = self._pool.submit(self._commit, step, host)

    def wait_until_finished(self) -> None:
        """Block until an in-flight async save has committed; raise its
        error if it failed."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def _commit(self, step: int, host) -> None:
        target = self._step_dir(step)
        for d in sorted(os.listdir(self._root)):
            if _STALE.fullmatch(d):  # a crashed save's droppings
                shutil.rmtree(os.path.join(self._root, d), ignore_errors=True)
        tmp = f"{target}.tmp{os.getpid()}"
        os.makedirs(tmp)
        tensors: list = []
        structure = _flatten(host, tensors)
        torch.save(tensors, os.path.join(tmp, TENSORS))
        with open(os.path.join(tmp, TREE), "wb") as f:
            pickle.dump(structure, f, protocol=pickle.HIGHEST_PROTOCOL)
        # the manifest commits with the payload, in the same rename
        elastic.write_manifest(
            elastic.world_manifest(self._comm,
                                   files=elastic.file_digests(tmp)),
            os.path.join(tmp, elastic.MANIFEST_NAME))
        # a re-save of a step: the old snapshot stays a step until the
        # new one is whole (os.rename cannot replace a directory)
        old = f"{target}.old{os.getpid()}"
        if os.path.exists(target):
            os.rename(target, old)
        os.rename(tmp, target)
        shutil.rmtree(old, ignore_errors=True)
        # its digests were just taken from these files: the inventory
        # need not read them back
        self._verified[target] = (elastic.snapshot_signature(target), True)
        self._gc()

    # -- inventory -----------------------------------------------------
    def _available_steps(self) -> list:
        """This rank's complete, digest-verified steps, ascending."""
        steps = []
        for d in sorted(os.listdir(self._root)):
            m = _STEP.fullmatch(d)
            if m and self._is_complete(os.path.join(self._root, d)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _is_complete(self, path: str) -> bool:
        sig = elastic.snapshot_signature(path)
        cached = self._verified.get(path)
        if cached is not None and cached[0] == sig:
            return cached[1]
        ok = elastic.verify_snapshot(path)
        self._verified[path] = (sig, ok)
        if not ok:
            emit("snapshot_corrupt", "checkpoint.inventory", path=path)
        return ok

    def _gc(self) -> None:
        """Keep this rank's newest ``keep`` steps (no barrier: a dead
        rank must not hang the others here)."""
        steps = self._available_steps()
        for s in steps[:-self._keep] if self._keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            self._verified.pop(self._step_dir(s), None)

    # -- agreement and resume ------------------------------------------
    def newest_common_step(self) -> Optional[int]:
        """The newest step every rank holds: the max of the intersection
        of the ranks' inventories, exchanged by ``lockstep_allgather``
        (a collective: every rank calls it).  An in-flight save counts."""
        self.wait_until_finished()
        inventories = lockstep_allgather(
            self._comm, self._available_steps(),
            site="checkpoint.newest_common_step")
        common = set(inventories[0])
        for inv in inventories[1:]:
            common &= set(inv)
        return max(common) if common else None

    def resume(self, like: Optional[Dict[str, Any]] = None):
        """``(step, state)`` of the newest common step, or ``(None,
        None)`` when there is none.  ``state`` has the saved tree
        structure and dtypes; with ``like`` its tensors land on the
        devices of ``like``'s tensors at the same places (else on the
        CPU).  A collective."""
        step = self.newest_common_step()
        if step is None:
            return None, None
        target = self._step_dir(step)
        manifest = elastic.read_world_manifest(target) or {}
        old_world = manifest.get("world_size")
        if old_world is not None and int(old_world) != self._comm.size:
            if like is None:
                raise WorldResizeRequiredError(
                    f"checkpoint step {step} was written at world size "
                    f"{old_world} but this world has {self._comm.size} "
                    "ranks; resharding needs a template of the new "
                    "world's state (resume(like=...))",
                    site="checkpoint.resume")
            elastic.reshard_state(None, like, int(old_world),
                                  self._comm.size, label=f"step_{step}")
        tensors = torch.load(os.path.join(target, TENSORS),
                             map_location="cpu", weights_only=True)
        with open(os.path.join(target, TREE), "rb") as f:
            state = _unflatten(pickle.load(f), tensors)
        return step, state if like is None else _onto(state, like)

    # -- trainer-extension protocol ------------------------------------
    @staticmethod
    def _trainer_state(trainer) -> Dict[str, Any]:
        upd = trainer.updater
        if upd.model is None:
            raise ValueError(
                "the checkpointer saves the Updater's model: build the "
                "updater as Updater(iterator, step, model=model)")
        return {"params": upd.model.state_dict(),
                "opt_state": upd.step_fn.optimizer.state_dict(),
                "trainer": trainer.state_dict()}

    def __call__(self, trainer) -> None:
        """Save the model's ``state_dict``, the multi-node optimizer's
        state (its error-feedback residual included) and the trainer's
        position as the current iteration."""
        self.save(trainer.iteration, self._trainer_state(trainer))

    def restore_trainer(self, trainer) -> Optional[int]:
        """Put the newest common snapshot back into the trainer's model,
        optimizer and loop; the step, or None when there is none."""
        step, state = self.resume(like=self._trainer_state(trainer))
        if step is None:
            return None
        trainer.updater.model.load_state_dict(state["params"])
        trainer.updater.step_fn.optimizer.load_state_dict(state["opt_state"])
        trainer.load_state_dict(state["trainer"])
        return step

    def finalize(self, trainer=None) -> None:
        """Drain an in-flight save (so process exit cannot cut one short)
        and stop the writer thread."""
        try:
            self.wait_until_finished()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


def create_multi_node_checkpointer(name: str, comm, path: str = "checkpoints",
                                   trigger=(1, "epoch"), keep: int = 3,
                                   use_async: bool = False
                                   ) -> _MultiNodeCheckpointer:
    """Parity: ``chainermn.create_multi_node_checkpointer(name, comm)``
    (see the module docstring)."""
    return _MultiNodeCheckpointer(name, comm, path=path, trigger=trigger,
                                  keep=keep, use_async=use_async)
