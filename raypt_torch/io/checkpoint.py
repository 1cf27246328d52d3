"""Checkpoint and resume of progressive renders and inverse-rendering
jobs (`raypt/io/checkpoint.py`), in the JAX package's file format, so a
file written by either package loads in the other:

  render state: npz with "accum" (H, W, 3) f32, "frame_index" int64 and
    "key", the key's two uint32 words (`jax.random.key_data`'s pair,
    `Key(k0, k1)` here);
  pytree: npz with one array a leaf under its JAX path string, "." +
    field for a dataclass field or a `SceneParams` parameter, "['k']"
    for a dict key, "[i]" for a list or tuple item, joined by "/"; a
    None field is no leaf. "__step__" int64, and "__meta__" the JSON of
    `meta` as bytes.

The orbax functions of the JAX package are not ported (JAX-only).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..rng.sampler import Key


def save_render_state(path: str, accum, frame_index: int, key: Key) -> None:
    np.savez_compressed(path, accum=_numpy(accum),
                        frame_index=np.int64(frame_index),
                        key=np.array([key.k0, key.k1], np.uint32))


def load_render_state(path: str, device="cuda"):
    """(accum (H, W, 3) f32 tensor on `device`, frame_index, Key)."""
    with np.load(path) as z:
        k0, k1 = (int(x) for x in np.asarray(z["key"], np.uint32).reshape(2))
        return (torch.from_numpy(np.array(z["accum"])).to(device),
                int(z["frame_index"]), Key(k0, k1))


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _children(tree):
    """(path string, child) of a node, in the JAX flattening order; None
    for a leaf."""
    from ..diff.params import FIELDS, SceneParams
    if isinstance(tree, SceneParams):
        return [("." + f, getattr(tree, f)) for f in FIELDS]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [("." + f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    kids = _children(tree)
    if kids is None:
        return {prefix: _numpy(tree)}
    out = {}
    for name, child in kids:
        if child is not None:
            out.update(_flatten(child, f"{prefix}/{name}" if prefix
                                else name))
    return out


def save_pytree(path: str, tree, step: int = 0,
                meta: dict | None = None) -> None:
    """Save a tree of tensors or arrays (a SceneParams, a dataclass, a
    dict, a list) with its step and optional JSON metadata."""
    flat = _flatten(tree)
    flat["__step__"] = np.int64(step)
    if meta:
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **flat)


def _restore(like, z, prefix: str):
    from ..diff.params import SceneParams, params_from_numpy
    kids = _children(like)
    if kids is None:
        if prefix not in z:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        value = np.array(z[prefix])
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(value).to(like.device, like.dtype)
        return value
    values = {name: None if child is None else
              _restore(child, z, f"{prefix}/{name}" if prefix else name)
              for name, child in kids}
    if isinstance(like, SceneParams):
        dev = like.albedo_logits.device
        return params_from_numpy({k[1:]: None if v is None else _numpy(v)
                                  for k, v in values.items()}, dev)
    if isinstance(like, dict):
        return {k: values[f"[{k!r}]"] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(values[f"[{i}]"] for i in range(len(like)))
    return dataclasses.replace(like, **{k[1:]: v for k, v in values.items()})


def load_pytree(path: str, like):
    """(the tree of `like`'s structure with the saved leaves, on its
    leaves' devices, step). Raises KeyError when a leaf is missing."""
    with np.load(path) as z:
        tree = _restore(like, z, "")
        step = int(z["__step__"]) if "__step__" in z else 0
    return tree, step
