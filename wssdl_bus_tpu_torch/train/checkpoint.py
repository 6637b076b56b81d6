"""Snapshots of the port (counterpart of ``wssdl_bus_tpu/train/checkpoint.py``).

The JAX package writes orbax directories, which the port cannot import, so
the port keeps its own format with the same layout rules:

  * a snapshot is a directory ``<prefix><infix>_iter_<step>``;
  * ``host_state.pkl``, which lists the snapshot's ``components``, is
    written first and atomically;
  * then ``variables.pt`` (``{"variables": state_dict, "step": step}``),
    ``opt_state.pt`` and ``opt_state_ws.pt`` as given, each written to a
    temporary name and renamed, so a component that exists is whole;
  * ``latest_checkpoint`` takes the newest snapshot whose listed
    components all exist (a crash mid-write leaves one missing).

Tensors are saved on the CPU (``torch.save``); :func:`load_checkpoint`
maps them to the device the caller names.  A JAX snapshot is not readable
here: carry JAX weights across with ``models/convert.py:params_from_jax``
and save them with :func:`save_checkpoint`.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Optional

import torch

COMPONENTS = ("variables", "opt_state", "opt_state_ws")


def _ckpt_dir(output_dir: str, prefix: str, infix: str, step: int) -> str:
    return os.path.join(os.path.abspath(output_dir),
                        f"{prefix}{infix}_iter_{step}")


def _to_cpu(tree):
    """A copy of ``tree`` with every tensor detached on the CPU: the write
    may run on another thread while training updates the live tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class _Writer:
    """One background thread writing one snapshot's components in order."""

    def __init__(self):
        self._thread = None
        self._err = []

    def submit(self, jobs) -> None:
        self.wait()

        def run():
            try:
                for obj, path in jobs:
                    _save_atomic(obj, path)
            except BaseException as e:  # noqa: BLE001 - raised at wait()
                self._err.append(e)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err:
            raise RuntimeError("snapshot write failed") from self._err.pop()


def make_snapshot_writers() -> dict:
    """A background writer for overlapped snapshot writes; pass to
    ``save_checkpoint(checkpointers=...)`` and wait with
    :func:`wait_snapshot_writers` before reading the snapshot.  A new save
    on the same writers first waits out the previous one."""
    return {"writer": _Writer()}


def wait_snapshot_writers(writers: Optional[dict]) -> None:
    for w in (writers or {}).values():
        w.wait()


def save_checkpoint(output_dir: str, prefix: str, infix: str, step: int,
                    variables, opt_state=None, opt_state_ws=None,
                    host_state: Optional[dict] = None,
                    checkpointers: Optional[dict] = None) -> str:
    """Write a snapshot; -> its directory.

    ``variables``: the model's ``state_dict()``.  ``opt_state`` /
    ``opt_state_ws``: picklable optimizer states (tensors allowed), the
    second for the alternating regime's weak step.  ``host_state``:
    picklable host-side training state.  ``checkpointers``: writers from
    :func:`make_snapshot_writers`, to write the tensors on a background
    thread (the tensors are copied to the CPU first, on the caller's
    thread); without them the write is synchronous."""
    path = _ckpt_dir(output_dir, prefix, infix, step)
    os.makedirs(path, exist_ok=True)
    host_state = dict(host_state or {})
    host_state["components"] = ["variables"] + \
        (["opt_state"] if opt_state is not None else []) + \
        (["opt_state_ws"] if opt_state_ws is not None else [])
    tmp = os.path.join(path, "host_state.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(host_state, f, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, os.path.join(path, "host_state.pkl"))

    jobs = [({"variables": _to_cpu(variables), "step": int(step)},
             os.path.join(path, "variables.pt"))]
    for name, state in (("opt_state", opt_state),
                        ("opt_state_ws", opt_state_ws)):
        if state is not None:
            jobs.append((_to_cpu(state), os.path.join(path, f"{name}.pt")))
    if checkpointers is None:
        for obj, p in jobs:
            _save_atomic(obj, p)
    else:
        checkpointers["writer"].submit(jobs)
    return path


def load_checkpoint(path: str, device="cpu", opt_state: bool = False,
                    opt_state_ws: bool = False):
    """-> (variables state_dict, step[, opt_state][, opt_state_ws]) with
    tensors on ``device``; a missing ``opt_state_ws`` comes back None."""
    path = os.path.abspath(path)
    state = torch.load(os.path.join(path, "variables.pt"),
                       map_location=device, weights_only=False)
    out = [state["variables"], int(state["step"])]
    for name, want in (("opt_state", opt_state),
                       ("opt_state_ws", opt_state_ws)):
        if want:
            p = os.path.join(path, f"{name}.pt")
            out.append(torch.load(p, map_location=device, weights_only=False)
                       if os.path.exists(p) else None)
    return tuple(out)


def load_host_state(path: str) -> Optional[dict]:
    p = os.path.join(os.path.abspath(path), "host_state.pkl")
    if not os.path.exists(p):
        return None
    with open(p, "rb") as f:
        return pickle.load(f)


def _is_complete(path: str) -> bool:
    """A snapshot is whole iff every component its host pickle lists
    exists (each is renamed into place only once written).  A snapshot
    without a readable host pickle is judged on ``variables.pt`` alone,
    and one with a truncated pickle is not whole."""
    if not os.path.isfile(os.path.join(path, "variables.pt")):
        return False
    try:
        host = load_host_state(path)
    except Exception:
        return False
    return all(os.path.isfile(os.path.join(path, f"{c}.pt"))
               for c in (host or {}).get("components", []))


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest complete snapshot in ``output_dir``: a half-written one
    from an interrupted run is skipped for the one before it."""
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        if "_iter_" not in name:
            continue
        try:
            step = int(name.rsplit("_iter_", 1)[1])
        except ValueError:
            continue
        path = os.path.join(output_dir, name)
        if step > best_step and os.path.isdir(path) and _is_complete(path):
            best, best_step = path, step
    return best
