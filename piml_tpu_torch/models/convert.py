"""Weights across frameworks: flax parameter trees → PyTorch ``state_dict``.

The port's modules carry the flax module names (``models/blocks.py``), so
a flax leaf ``a/b/dense_0/kernel`` becomes ``a.b.dense_0.weight``.  A flax
``Dense`` kernel is ``(in, out)``; a ``torch.nn.Linear`` weight is
``(out, in)``, hence the transpose.  A parameter declared at the top of
the model (``pinnsf2``'s scalar ``tau_delta``) keeps its name.

``fixtures/pinnsf_bm_gc_finetuned.npz`` holds the trained ``pinnsf_bm``
weights of ``bench_fixtures/pinnsf_bm_gc_finetuned.msgpack`` and
``fixtures/pinnsf_bm_gc_pretrained.npz`` the pretrained ones the finetune
warm-starts from (``bench_fixtures/pinnsf_bm_gc_pretrained.msgpack``), as
flat numpy arrays (keys like ``ped_encoder/dense_0/kernel``), each written
once with ``np.savez(path, **flatten_tree(msgpack_restore(blob)["params"]))``
so that hosts without flax or msgpack can load them.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

_FIXTURES = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "fixtures")
FIXTURE = os.path.join(_FIXTURES, "pinnsf_bm_gc_finetuned.npz")
PRETRAINED = os.path.join(_FIXTURES, "pinnsf_bm_gc_pretrained.npz")


def flatten_tree(tree: Mapping[str, Any], prefix: str = ""
                 ) -> Dict[str, np.ndarray]:
    """Nested dicts of arrays → ``{"a/b/c": array}``."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_tree(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """``{"a/b/c": array}`` → nested dicts."""
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(val)
    return tree


def params_from_flax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """A flax parameter tree (nested dicts of numpy arrays, with or without
    the top-level ``params`` collection) → the port's ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, arr in flatten_tree(tree).items():
        *mods, leaf = path.split("/")
        name = ".".join(mods)
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel":
            sd[name + ".weight"] = torch.from_numpy(np.array(arr.T, order="C"))
        elif leaf == "bias":
            sd[name + ".bias"] = torch.from_numpy(np.array(arr))
        elif not mods:
            sd[leaf] = torch.from_numpy(np.array(arr))
        else:
            raise ValueError(f"unexpected flax leaf {path!r}")
    return sd


def load_fixture(path: str = FIXTURE) -> "OrderedDict[str, torch.Tensor]":
    """Committed ``pinnsf_bm`` weights as a ``state_dict``: the finetuned
    ones by default, ``PRETRAINED`` for the finetune's warm start."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_flax(unflatten_tree(flat))
