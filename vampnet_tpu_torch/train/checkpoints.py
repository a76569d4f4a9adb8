"""Training checkpoint manager (counterpart of
`vampnet_tpu/train/checkpoints.py`, which writes the state with orbax).

Layout:
  <save_path>/<tag>/state/state.pt  — the train state (`TrainState.state_dict`:
                                      params, optimizer moments and count,
                                      step), written with `torch.save`
  <save_path>/<tag>/tracker.json
  <save_path>/<tag>/model.vtpu      — the inference-ready LM
                                      (`checkpoints.save_lm`; the JAX
                                      package's `load_lm` reads it too)
  <save_path>/<tag>/lora.vtpu       — the adapters alone (fine-tune runs)
Tags: latest (every save), best (validation loss), <N>k at save_iters.

Crash safety: a tag's last committed state is never destroyed before its
replacement commits. save() renames `state/` to `state.prev/` (with a paired
`tracker.json.prev`) instead of deleting it; the new state is written into
`state.tmp/` and renamed to `state/` once complete, and only then is the
prev copy removed. A crash in between leaves `state.prev/` restorable:
has_tag() and restore() fall back to it.

A job of several processes (`torch.distributed`) saves collectively:
every rank calls save(), which first waits at a barrier (so no rank gathers
while rank 0 still moves the old tag's files), then gathers the sharded
state to whole tensors (`ShardedTrainState.state_dict`, a collective), and
only the main rank (`is_main`) touches the files. The files have the
single-card layout whatever the mesh, so a run resumes on any mesh (restore
returns whole tensors, which `load_state_dict` cuts again).

save() copies the state, and the LM in the `.vtpu` layout, into host
buffers that the manager keeps for the next save (pinned for a card's
tensors: one copy wave and one synchronize). With `async_save`, save()
returns once that copy is done (the training step may then overwrite the
device tensors), and the files are written on a background thread; the next
save(), restore(), has_tag() or wait_until_finished() waits for it and
re-raises its error.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import torch

from .. import checkpoints
from ..convert import lm_tree_from_state_dict
from ..modules.lora import lora_state_dict

STATE_FILE = "state.pt"


def _leaves(tree: Any, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _rebuild(tree: Any, leaves: dict, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}/{i}") for i, v in enumerate(tree))
    return leaves[prefix]


def _barrier(name: str) -> None:
    """Every rank of a job reaches this point before any goes on."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class CheckpointManager:
    def __init__(self, save_path, is_main: bool = True, async_save: bool = False):
        self.root = Path(save_path).absolute()
        self.is_main = is_main
        self.async_save = async_save
        # host copies of the saved tensors, by path, reused by every save
        # (pinned for a card's tensors: one fast copy wave)
        self._host: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # tags whose old `state.prev/` awaits deletion once the new `state/`
        # commits
        self._pending_prev: list = []

    def _reap_committed_prev(self) -> None:
        """Delete preserved `state.prev/` dirs whose replacement committed
        (call only after the writer finished: `state/` existing then means
        committed)."""
        remaining = []
        for prev in self._pending_prev:
            if (prev.parent / "state").exists():
                shutil.rmtree(prev, ignore_errors=True)
                tprev = prev.parent / "tracker.json.prev"
                if tprev.exists():
                    tprev.unlink()
            else:
                remaining.append(prev)
        self._pending_prev = remaining

    def wait_until_finished(self) -> None:
        """Block until an in-flight save has committed; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("a checkpoint write failed") from err
        self._reap_committed_prev()

    def save(self, tag: str, state, lm_config, tracker_state: Optional[dict] = None,
             fine_tune: bool = False) -> None:
        """Save `state` (a `TrainState` or a `ShardedTrainState`) under
        `tag`; in a job, on every rank (module docstring)."""
        self.wait_until_finished()
        _barrier(f"ckpt-save-{tag}")
        if not self.is_main:
            state.state_dict()  # the gather is a collective: join it
            return
        tag_dir = self.root / tag
        state_dir, prev_dir = tag_dir / "state", tag_dir / "state.prev"
        tag_dir.mkdir(parents=True, exist_ok=True)
        if state_dir.exists():
            # keep the committed state until the new write commits
            if prev_dir.exists():
                shutil.rmtree(prev_dir)
            state_dir.rename(prev_dir)
            tpath = tag_dir / "tracker.json"
            if tpath.exists():
                shutil.copyfile(tpath, tag_dir / "tracker.json.prev")
            self._pending_prev.append(prev_dir)
        elif prev_dir.exists():
            # a crash leftover: the fallback until this save commits
            self._pending_prev.append(prev_dir)
        sd = state.state_dict()
        tree = self._to_host({"state": sd, "model": lm_tree_from_state_dict(sd["params"])})

        def write():
            # the extras first, then the state: a crash before the state's
            # rename leaves state.prev/ and its tracker.json.prev together
            if tracker_state is not None:
                (tag_dir / "tracker.json").write_text(json.dumps(tracker_state))
            params = tree["model"]
            checkpoints.save_lm(tag_dir / "model.vtpu", lm_config, params)
            if fine_tune:
                checkpoints.save_lora(tag_dir / "lora.vtpu", lora_state_dict(params))
            tmp = tag_dir / "state.tmp"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            torch.save(tree["state"], tmp / STATE_FILE)
            tmp.rename(state_dir)

        if not self.async_save:
            write()
            self._reap_committed_prev()
            return

        def run():
            try:
                write()
            except BaseException as e:  # re-raised by wait_until_finished
                self._error = e

        self._thread = threading.Thread(target=run, name=f"checkpoint-{tag}", daemon=False)
        self._thread.start()

    def _to_host(self, tree: Any) -> Any:
        """`tree` with every tensor copied into this manager's host buffer
        for its path (laid out contiguously), so later in-place updates of
        the state do not reach the copy; one synchronize for a card's."""
        leaves, on_card = {}, False
        for path, x in _leaves(tree):
            if isinstance(x, torch.Tensor):
                buf = self._host.get(path)
                if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                    buf = self._host[path] = torch.empty(x.shape, dtype=x.dtype,
                                                         pin_memory=x.is_cuda)
                buf.copy_(x, non_blocking=x.is_cuda)
                on_card |= x.is_cuda
                x = buf
            leaves[path] = x
        if on_card:
            torch.cuda.synchronize()
        return _rebuild(tree, leaves)

    def restore(self, tag: str):
        """(the train state's tree on the CPU, the tracker state or None),
        from `state/` or, after a crash mid-save, from `state.prev/` and its
        paired tracker snapshot. Load it with `TrainState.load_state_dict`."""
        self.wait_until_finished()
        tag_dir = self.root / tag
        state_dir, tpath = tag_dir / "state", tag_dir / "tracker.json"
        if not state_dir.exists() and (tag_dir / "state.prev").exists():
            state_dir = tag_dir / "state.prev"
            if (tag_dir / "tracker.json.prev").exists():
                tpath = tag_dir / "tracker.json.prev"
        tree = torch.load(state_dir / STATE_FILE, map_location="cpu", weights_only=True)
        tracker_state = json.loads(tpath.read_text()) if tpath.exists() else None
        return tree, tracker_state

    def has_tag(self, tag: str) -> bool:
        self.wait_until_finished()
        tag_dir = self.root / tag
        return (tag_dir / "state").exists() or (tag_dir / "state.prev").exists()
