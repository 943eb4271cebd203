"""Reading the port's checkpoints: flax's msgpack serialization decoded
in plain Python (a frozen copy of the port's ``bridge.read_checkpoint``)
and a param tree copied into a reference model by name (a ``Dense``
kernel ``[in, out]`` becomes ``Linear.weight`` ``[out, in]``, an ``Embed``
table maps across as it is).
"""

from __future__ import annotations

import struct
from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1          # flax serialization._MsgpackExtType.ndarray
_CHUNKED = '__msgpack_chunked_array__'

# fixed-width msgpack types: first byte -> (struct format, size)
_FIXED = {0xca: ('>f', 4), 0xcb: ('>d', 8),
          0xcc: ('>B', 1), 0xcd: ('>H', 2), 0xce: ('>I', 4), 0xcf: ('>Q', 8),
          0xd0: ('>b', 1), 0xd1: ('>h', 2), 0xd2: ('>i', 4), 0xd3: ('>q', 8)}
# length-prefixed types: first byte -> (kind, length format, length size)
_SIZED = {0xc4: ('bin', '>B', 1), 0xc5: ('bin', '>H', 2), 0xc6: ('bin', '>I', 4),
          0xd9: ('str', '>B', 1), 0xda: ('str', '>H', 2), 0xdb: ('str', '>I', 4),
          0xdc: ('array', '>H', 2), 0xdd: ('array', '>I', 4),
          0xde: ('map', '>H', 2), 0xdf: ('map', '>I', 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_EXT = {0xc7: ('>B', 1), 0xc8: ('>H', 2), 0xc9: ('>I', 4)}


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    """Decode the msgpack object at ``buf[pos:]``; returns (object, end)."""
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _container('map', b & 0x0f, buf, pos)
    if 0x90 <= b <= 0x9f:
        return _container('array', b & 0x0f, buf, pos)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return buf[pos:pos + n].decode('utf-8'), pos + n
    if b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b], pos
    if b in _FIXED:
        fmt, size = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if b in _SIZED:
        kind, fmt, size = _SIZED[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += size
        if kind in ('array', 'map'):
            return _container(kind, n, buf, pos)
        raw = buf[pos:pos + n]
        return (raw.decode('utf-8') if kind == 'str' else raw), pos + n
    if b in _FIXEXT:
        n = _FIXEXT[b]
    elif b in _EXT:
        fmt, size = _EXT[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += size
    else:
        raise ValueError(f'msgpack: unknown type byte 0x{b:02x} at {pos - 1}')
    code = struct.unpack_from('>b', buf, pos)[0]
    data = buf[pos + 1:pos + 1 + n]
    return _ext(code, data), pos + 1 + n


def _container(kind: str, n: int, buf: bytes, pos: int) -> Tuple[Any, int]:
    if kind == 'array':
        out = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            out.append(item)
        return out, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        out[key], pos = _unpack(buf, pos)
    if _CHUNKED in out:
        raise ValueError('msgpack: chunked arrays are not supported')
    return out, pos


def _ext(code: int, data: bytes) -> np.ndarray:
    if code != _EXT_NDARRAY:
        raise ValueError(f'msgpack: unsupported extension type {code}')
    (shape, dtype, raw), end = _unpack(data, 0)
    if end != len(data):
        raise ValueError('msgpack: malformed array extension')
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """Decode flax's msgpack serialization (``flax.serialization.
    msgpack_restore``) into nested dicts of numpy arrays."""
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f'msgpack: {len(data) - end} trailing bytes')
    return obj


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The param tree of a checkpoint the JAX package or the port wrote."""
    with open(path, 'rb') as f:
        return msgpack_restore(f.read())


def _flatten(tree: Mapping, prefix: str = '') -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f'{prefix}{k}/'))
        else:
            out[f'{prefix}{k}'] = v
    return out


def load_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Copy the param tree ``tree`` (``{'params': ...}`` or the params
    themselves) into ``model``; every parameter of the model must be in
    it, and every leaf must have its parameter."""
    state = {}
    for path, value in _flatten(tree.get('params', tree)).items():
        *mod, leaf = path.split('/')
        arr = np.asarray(value)
        if leaf == 'kernel':
            arr = arr.T
        name = '.'.join(mod + [{'kernel': 'weight',
                                'embedding': 'weight'}.get(leaf, leaf)])
        state[name] = torch.from_numpy(np.ascontiguousarray(arr).copy())
    model.load_state_dict(state, strict=True)


def subtree(tree: Mapping, key: str) -> Dict[str, Any]:
    """``tree``'s params under ``key`` (a prop-opt checkpoint keeps the
    ``prop`` model under ``vae/``), or all of them where ``key`` is
    empty."""
    params = tree.get('params', tree)
    return {'params': params[key] if key else params}
