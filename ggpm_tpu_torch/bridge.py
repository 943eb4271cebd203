"""Weight bridge: flax checkpoints of the JAX package into the port's modules.

``ggpm_tpu/train/checkpoint.py`` writes a param tree with flax's
``serialization.to_bytes``: msgpack maps of strings, with every array packed
as msgpack extension type 1 holding ``[shape, dtype name, C-order bytes]``.
``read_checkpoint`` decodes that format in plain Python (neither flax nor
msgpack is needed), and ``load_flax_params`` copies the tree into a port
model: a ``Dense`` kernel ``[in, out]`` becomes ``Linear.weight``
``[out, in]``; an ``Embed`` table maps across as it is; the path
``vae/encoder/tree_encoder/rnn/W_f/kernel`` becomes the parameter
``vae.encoder.tree_encoder.rnn.W_f.weight``.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .graph.vocab import PairVocab, load_vocab_file
from .models.vae import ModelConfig, PropOptVAE

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
    """The param tree of a checkpoint written by
    ``ggpm_tpu.train.checkpoint.save_params``."""
    with open(path, 'rb') as f:
        return msgpack_restore(f.read())


def flatten(tree: Mapping, prefix: str = '') -> Dict[str, Any]:
    """``{'a': {'b': x}}`` -> ``{'a/b': x}``."""
    out = {}
    for k, v in tree.items():
        path = f'{prefix}{k}'
        if isinstance(v, Mapping):
            out.update(flatten(v, path + '/'))
        else:
            out[path] = v
    return out


def load_flax_params(model: torch.nn.Module,
                     tree: Mapping) -> Dict[str, np.ndarray]:
    """Copy a flax param tree (a checkpoint, or ``model.init``'s output with
    array leaves) into ``model``.  Every parameter of ``model`` must be in
    the tree with its shape.  Returns the leaves under ``vae/decoder/``,
    which the port has no module for yet, as ``{path: array}``; any other
    leaf the model lacks is an error."""
    flat = flatten(tree.get('params', tree))
    own = model.state_dict()
    state, aside, unknown = {}, {}, []
    for path, value in flat.items():
        arr = np.asarray(value)
        *mod, leaf = path.split('/')
        if leaf == 'kernel':
            arr = arr.T
        name = '.'.join(mod + ['bias' if leaf == 'bias' else 'weight'])
        if name in own and leaf in ('kernel', 'bias', 'embedding'):
            state[name] = torch.from_numpy(np.ascontiguousarray(arr).copy())
        elif path.startswith('vae/decoder/'):
            aside[path] = np.asarray(value)
        else:
            unknown.append(path)
    if unknown:
        raise ValueError(f'flax params with no port module: {unknown}')
    model.load_state_dict(state, strict=True)
    return aside


def load_model(ckpt_path: str, vocab_path: str, device: str = 'cuda'
               ) -> Tuple[PropOptVAE, PairVocab]:
    """The trained prop-opt model of a checkpoint and its vocab file, in
    eval mode on ``device``.  The configuration is ``ModelConfig``'s
    defaults with the vocab's sizes; the decoder's weights are read and
    set aside until the decode slice."""
    vocab = load_vocab_file(vocab_path)
    hvocab, ivocab = vocab.size()
    model = PropOptVAE(ModelConfig(hvocab_size=hvocab, ivocab_size=ivocab))
    load_flax_params(model, read_checkpoint(ckpt_path))
    return model.eval().to(device), vocab
