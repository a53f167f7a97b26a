"""Checkpoint / resume (port of utils/checkpoint.py; SURVEY §5: the
reference has none).  Two states are checkpointed: (a) progressive
rendering's accumulation (``RenderCheckpoint``) and (b) an inverse
rendering's optimization (``OptimCheckpoint``), so preemption loses at
most one round.

The file is the JAX package's: a ``np.savez`` of the leaves of a tree as
``leaf_0``, ``leaf_1``, ... in JAX's flattening order, ``__treedef__`` (a
description of the structure, as bytes; neither package reads it back)
and ``__meta__`` (JSON, as bytes).  So a checkpoint written by either
package loads in the other.  The leaf order is JAX's:

- a tensor, a numpy array or a Python number is a leaf; None is an empty
  subtree;
- a tuple or a list: its items in order; a dict: its values in sorted key
  order;
- a dataclass (the port's RenderTarget, TypedRenderTarget, Materials,
  ...): its fields in order, where tensor-valued and None fields are
  children and every other field (an int width, a str format) is static,
  as the JAX package's ``pytree_dataclass`` declares them.

Camera files stay in the reference-compatible text format
(io/camera_io.py).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from visionaray_torch.device import to_numpy

_NUMBER = (bool, int, float, np.number)


def _is_child(v) -> bool:
    return v is None or isinstance(v, (torch.Tensor, np.ndarray))


def _flatten(tree, leaves: list) -> str:
    """Append the leaves of ``tree`` to ``leaves``; returns a description
    of its structure."""
    if tree is None:
        return "None"
    if isinstance(tree, (torch.Tensor, np.ndarray, _NUMBER)):
        leaves.append(tree)
        return "*"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    if dataclasses.is_dataclass(tree):
        parts = []
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            parts.append(f"{f.name}=" + (_flatten(v, leaves) if _is_child(v)
                                         else repr(v)))
        return f"{type(tree).__name__}({', '.join(parts)})"
    raise TypeError(f"checkpoint: cannot flatten {type(tree).__name__}")


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` (numpy arrays)."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(next(leaves)).to(like.device)
    if isinstance(like, np.ndarray):
        return np.asarray(next(leaves))
    if isinstance(like, _NUMBER):
        return type(like)(np.asarray(next(leaves)).item())
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if dataclasses.is_dataclass(like):
        kw = {f.name: _unflatten(getattr(like, f.name), leaves)
              for f in dataclasses.fields(like)
              if _is_child(getattr(like, f.name))}
        return dataclasses.replace(like, **kw)
    raise TypeError(f"checkpoint: cannot rebuild {type(like).__name__}")



def save_pytree(path: str, tree: Any, metadata: dict | None = None):
    """Save a tree of tensors (dataclasses, tuples, lists, dicts) to
    ``path`` (.npz), leaves copied to the host."""
    leaves: list = []
    desc = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": to_numpy(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(desc.encode(), dtype=np.uint8)
    if metadata:
        arrays["__meta__"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return path


def load_pytree(path: str, like: Any):
    """Load arrays saved by save_pytree (by either package) into the
    structure of ``like``, each tensor on the device of ``like``'s.

    Returns (tree, metadata).  The leaf count must match ``like``'s."""
    data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
    n_like = len(_leaves(like))
    n_saved = len([k for k in data.files if k.startswith("leaf_")])
    if n_saved != n_like:
        raise ValueError(f"checkpoint {path}: {n_saved} leaves, the "
                         f"structure given has {n_like}")
    tree = _unflatten(like, iter(data[f"leaf_{i}"] for i in range(n_like)))
    meta = None
    if "__meta__" in data.files:
        meta = json.loads(bytes(data["__meta__"]).decode())
    return tree, meta


def _leaves(tree) -> list:
    leaves: list = []
    _flatten(tree, leaves)
    return leaves


class RenderCheckpoint:
    """Progressive-render state: accumulation buffer + frame counter + seed.

    The reference's progressive state is just (accum buffer, frame_num)
    reset on camera move (viewer.cpp:353-364); here it survives restarts.
    """

    @staticmethod
    def save(path: str, rt, frame_num: int, seed: int = 0):
        return save_pytree(path, rt,
                           metadata={"frame_num": int(frame_num),
                                     "seed": int(seed),
                                     "kind": "render"})

    @staticmethod
    def load(path: str, rt_like):
        rt, meta = load_pytree(path, rt_like)
        if not meta or meta.get("kind") != "render":
            raise ValueError(f"not a render checkpoint: {path}")
        return rt, meta["frame_num"], meta.get("seed", 0)


class OptimCheckpoint:
    """Inverse-rendering state: a parameter dict, a ``torch.optim``
    optimizer's state dict and the step.  The optimizer's tensors are
    leaves (``state_dict()["state"]``); its ``param_groups`` (numbers,
    flags, parameter indices) travel in the metadata."""

    @staticmethod
    def save(path: str, params, opt_state, step: int):
        return save_pytree(path, (params, opt_state["state"]),
                           metadata={"step": int(step), "kind": "optim",
                                     "param_groups":
                                         opt_state["param_groups"]})

    @staticmethod
    def load(path: str, params_like, opt_state_like):
        """(params, optimizer state dict, step); ``opt_state_like`` is a
        state dict of the same optimizer with state for every parameter
        (e.g. after one step)."""
        (params, state), meta = load_pytree(
            path, (params_like, opt_state_like["state"]))
        if not meta or meta.get("kind") != "optim":
            raise ValueError(f"not an optimizer checkpoint: {path}")
        return params, {"state": state,
                        "param_groups": meta["param_groups"]}, meta["step"]
