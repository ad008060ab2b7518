"""Checkpointing: msgpack-serialised trees with a shape/dtype manifest.

Port of ``repro.training.checkpoint``: save/restore params + optimizer
state + step, atomically (tmp + rename), with a keep-last-k policy.  The
file layout is ``repro``'s, ``{b"step", b"treedef", b"leaves": [{b"dtype",
b"shape", b"data"}]}`` in msgpack, so a file either package writes the
other restores.  msgpack itself is not a dependency: the encoder and
decoder below cover what the layout uses (maps, arrays, byte strings and
ints).  Leaves are taken in
``jax.tree.flatten``'s order: a dict's values by sorted key, a
tuple's, list's or NamedTuple's in order, ``None`` holding no leaf.
"""
from __future__ import annotations

import os
import struct
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# msgpack, the subset the layout uses
# ---------------------------------------------------------------------------
def _pack(obj: Any, out: List[bytes]) -> None:
    if isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(struct.pack("B", obj))
        elif -32 <= obj < 0:
            out.append(struct.pack("b", obj))
        elif 0 <= obj:
            for code, fmt, lim in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                   (0xce, ">I", 1 << 32),
                                   (0xcf, ">Q", 1 << 64)):
                if obj < lim:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
        else:
            for code, fmt, lim in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                   (0xd2, ">i", 1 << 31),
                                   (0xd3, ">q", 1 << 63)):
                if obj >= -lim:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = len(obj)
        out.append(b"\xc4" + struct.pack(">B", n) if n < 1 << 8 else
                   b"\xc5" + struct.pack(">H", n) if n < 1 << 16 else
                   b"\xc6" + struct.pack(">I", n))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(struct.pack("B", 0x90 | n) if n < 16 else
                   b"\xdc" + struct.pack(">H", n) if n < 1 << 16 else
                   b"\xdd" + struct.pack(">I", n))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        n = len(obj)
        out.append(struct.pack("B", 0x80 | n) if n < 16 else
                   b"\xde" + struct.pack(">H", n) if n < 1 << 16 else
                   b"\xdf" + struct.pack(">I", n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj)}")


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
         0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_BINS = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}


def _unpack(buf: bytes, i: int) -> Tuple[Any, int]:
    c = buf[i]
    i += 1

    def length(fmt):
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)

    def seq(n, j):
        items = []
        for _ in range(n):
            x, j = _unpack(buf, j)
            items.append(x)
        return items, j

    def mapping(n, j):
        items, j = seq(2 * n, j)
        return dict(zip(items[0::2], items[1::2])), j

    if c < 0x80:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if c & 0xf0 == 0x80:
        return mapping(c & 0x0f, i)
    if c & 0xf0 == 0x90:
        return seq(c & 0x0f, i)
    if c in _INTS:
        return length(_INTS[c])
    if c in _BINS:
        n, j = length(_BINS[c])
        return buf[j:j + n], j + n
    if c in (0xdc, 0xdd):
        n, j = length(">H" if c == 0xdc else ">I")
        return seq(n, j)
    if c in (0xde, 0xdf):
        n, j = length(">H" if c == 0xde else ">I")
        return mapping(n, j)
    raise ValueError(f"msgpack type byte 0x{c:02x} is not supported")


def unpackb(buf: bytes) -> Any:
    obj, i = _unpack(buf, 0)
    if i != len(buf):
        raise ValueError(f"{len(buf) - i} trailing bytes after the object")
    return obj


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree.leaves``' order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``leaves`` put into ``like``'s structure."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def treedef_str(tree: Any) -> str:
    """A description of the structure in the style of ``str(treedef)``."""
    def desc(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {desc(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(desc(v) for v in node) + "])")
        if isinstance(node, list):
            return "[" + ", ".join(desc(v) for v in node) + "]"
        if isinstance(node, tuple):
            return "(" + ", ".join(desc(v) for v in node) + ")"
        return "*"
    return f"PyTreeDef({desc(tree)})"


def _pack_leaf(x) -> dict:
    t = torch.as_tensor(x).detach().cpu().contiguous()
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:       # numpy has no bfloat16: its bits
        data = t.view(torch.int16).numpy().tobytes()
    else:
        data = t.numpy().tobytes()
    return {b"dtype": name.encode(), b"shape": list(t.shape), b"data": data}


def _unpack_leaf(d: dict, device) -> torch.Tensor:
    name = d[b"dtype"].decode()
    shape = list(d[b"shape"])
    if name == "bfloat16":
        arr = np.frombuffer(d[b"data"], dtype=np.int16).reshape(shape)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        arr = np.frombuffer(d[b"data"], dtype=np.dtype(name)).reshape(shape)
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def save(path: str, tree: Any, step: int = 0) -> str:
    """Atomic save of a tree; returns the final path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {b"step": int(step),
               b"treedef": treedef_str(tree).encode(),
               b"leaves": [_pack_leaf(x) for x in tree_leaves(tree)]}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(payload))
    os.replace(tmp, path)
    return path


def restore(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (count and shapes checked),
    each leaf in the dtype it was saved in, on the device of ``like``'s
    leaf."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    leaves = tree_leaves(like)
    saved = payload[b"leaves"]
    assert len(saved) == len(leaves), (len(saved), len(leaves))
    got = []
    for d, ref in zip(saved, leaves):
        dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        t = _unpack_leaf(d, dev)
        assert tuple(t.shape) == tuple(np.shape(ref)), (tuple(t.shape),
                                                        tuple(np.shape(ref)))
        got.append(t)
    return tree_unflatten(like, got), int(payload[b"step"])


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.msgpack")

    def _steps(self) -> List[int]:
        return sorted(int(f[5:13]) for f in os.listdir(self.dir)
                      if f.startswith("ckpt_") and f.endswith(".msgpack"))

    def save(self, tree: Any, step: int) -> str:
        p = save(self._path(step), tree, step)
        self._gc()
        return p

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, like: Any) -> Optional[Tuple[Any, int]]:
        s = self.latest_step()
        if s is None:
            return None
        return restore(self._path(s), like)

    def _gc(self):
        for s in self._steps()[:-self.keep]:
            os.remove(self._path(s))
