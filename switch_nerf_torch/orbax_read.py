"""Read a JAX orbax checkpoint into the tree its msgpack twin holds.

The JAX package writes ``<step>/orbax`` whenever a run has more than one
process (``switch_nerf_tpu/checkpoints.py:64-66,95-121``,
``ocp.StandardCheckpointer``). Orbax 0.11 lays the train-state tree out
as:

  * ``_METADATA``: JSON with every leaf's key path (``key_metadata``: dict
    keys, sequence indices and namedtuple fields, in the order
    ``jax.tree_util`` flattens the tree) and value type; an empty node
    (optax's ``EmptyState``, MultiSteps' ``skip_state``) is a leaf of type
    ``None`` or ``Tuple`` that is not stored;
  * one OCDBT store (``ocdbt.py``) holding each array as zarr v2 under its
    path joined by dots: ``<name>/.zarray`` (shape, chunks, dtype, order,
    fill value, compressor) and one key per stored chunk
    (``<name>/i.j.k``; a 0-d array's chunk is ``<name>/0``), each chunk a
    zstd frame (``utils/zstd.py``) of its whole (edge chunks padded)
    bytes in the array's order. A chunk equal to the fill value may be
    left out.

``read_tree`` gives the nested dict that ``_msgpack.unpackb`` gives for
``state.msgpack`` of the same state: keys in the order flax writes them
(the flatten order), numpy leaves, bfloat16 leaves as ``torch.bfloat16``
tensors (read as raw uint16 and viewed), a scalar as a 0-d array, an empty
node as ``{}``. ``bridge.load_jax_train_state`` takes it from there.
"""
from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

from switch_nerf_torch import ocdbt
from switch_nerf_torch.utils.zstd import decompress

__all__ = ["read_tree", "read_array"]

# the train state's dtypes (bfloat16 read as its raw uint16)
_DTYPES = {"<f4": np.float32, "<i4": np.int32, "<u4": np.uint32,
           "bfloat16": np.uint16}
_EMPTY = ("None", "Tuple")           # EmptyState, MultiSteps' skip_state


def read_array(store, name: str) -> Union[np.ndarray, torch.Tensor]:
    """The zarr v2 array `name` of an OCDBT store, chunks assembled."""
    meta = json.loads(store[f"{name}/.zarray"])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']}")
    dtype = meta["dtype"]
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {dtype!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp}")
    np_dtype = np.dtype(_DTYPES[dtype])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, np_dtype)
    sep = meta.get("dimension_separator", ".")
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
        if key not in store:
            continue                      # equal to the fill value
        raw = store[key]
        if comp is not None:
            raw = decompress(raw)
        chunk = np.frombuffer(raw, np_dtype)
        if chunk.size != int(np.prod(chunks)):
            raise ValueError(f"{key}: {chunk.size} elements, chunks "
                             f"{list(chunks)}")
        chunk = chunk.reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, x.stop - x.start) for x in sl)]
    if dtype == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def read_tree(orbax_dir: Union[str, Path]) -> Dict[str, Any]:
    """The train-state tree of an orbax checkpoint directory (a step's
    ``orbax/``), as ``_msgpack.unpackb`` gives its msgpack twin."""
    orbax_dir = Path(orbax_dir)
    meta = json.loads((orbax_dir / "_METADATA").read_text())
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{orbax_dir}: not an OCDBT / zarr v2 checkpoint")
    store = ocdbt.open(orbax_dir)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        kind = entry["value_metadata"].get("value_type")
        if kind in _EMPTY:
            node[keys[-1]] = {}
        elif kind in ("jax.Array", "np.ndarray"):
            node[keys[-1]] = read_array(store, ".".join(keys))
        else:
            raise ValueError(f"{orbax_dir}: leaf {'/'.join(keys)} of type "
                             f"{kind!r}")
    return tree
