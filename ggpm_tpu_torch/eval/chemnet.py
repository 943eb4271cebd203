"""ChemNet inference network for real FCD computation, in PyTorch
(counterpart of ``ggpm_tpu/eval/chemnet.py``, whose layers are numpy).

The reference reports FCD through ``moses.get_all_metrics``
(evaluation/metrics.py:244-247), which runs the pretrained ChemNet (Preuer
et al. 2018, "Fréchet ChemNet Distance") over generated and reference
SMILES and takes the Fréchet distance between Gaussian fits of the
penultimate-layer activations.  The pretrained checkpoint is not available
offline, so this module ships the inference machinery behind a
checkpoint-file argument: supply a converted checkpoint and
``Metrics(fcd_ckpt=...)`` reports a real FCD; without one the suite keeps
the documented ``FCD: None`` + FP-Fréchet stand-in.

Checkpoint format (the JAX package's, unchanged):

* an ``.npz`` file containing a JSON layer spec under key ``spec`` (a
  0-d string array) plus one array per weight name referenced by the spec;
* the spec is a list of layer dicts evaluated sequentially on a
  ``[B, L, C]`` activation tensor::

      {"kind": "conv1d",  "w": NAME, "b": NAME, "stride": 1, "act": "selu"}
      {"kind": "gru",     "wx": NAME, "wh": NAME, "b": NAME}   # returns last h
      {"kind": "bigru",   ...same names with _fwd/_bwd suffixes}
      {"kind": "lstm",    "wx": NAME, "wh": NAME, "b": NAME}
      {"kind": "dense",   "w": NAME, "b": NAME, "act": "..."}
      {"kind": "maxpool", "size": 2}

  The network's final output is the activation vector FCD is computed on
  (ChemNet's 512-d penultimate layer in the official weights).

SMILES featurization follows the FCD reference implementation: one-hot over
a 35-symbol alphabet (two-character halogens/silicon tokenised first,
unknown characters map to the dedicated ``X`` slot) padded/truncated to 350
positions.  The network runs on its device (the card by default) in
batches of 128, with plain ``torch`` operations: the recurrent layers step
through the sequence with Keras' gate orders (GRU z, r, h with the reset
gate applied after the recurrent product; LSTM i, f, c, o).

``random_checkpoint`` builds a small randomly-initialised checkpoint in the
same format — used by the unit tests and as an executable format spec.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# FCD reference alphabet (fcd/utils.py in the published implementation):
# multi-char tokens are matched greedily, unknown characters become 'X'.
CHARSET: List[str] = [
    'C', 'N', 'O', 'H', 'F', 'Cl', 'P', 'B', 'Br', 'S', 'I', 'Si',
    '#', '(', ')', '+', '-', '1', '2', '3', '4', '5', '6', '7', '8',
    '=', '[', ']', '@', 'c', 'n', 'o', 's', 'X', '.',
]
_TWO_CHAR = {'Cl', 'Br', 'Si'}
_CHAR_IDX = {c: i for i, c in enumerate(CHARSET)}
MAX_LEN = 350


def tokenize(smiles: str) -> List[int]:
    out = []
    i = 0
    while i < len(smiles):
        two = smiles[i:i + 2]
        if two in _TWO_CHAR:
            out.append(_CHAR_IDX[two])
            i += 2
            continue
        out.append(_CHAR_IDX.get(smiles[i], _CHAR_IDX['X']))
        i += 1
    return out


def featurize(smiles_list: Sequence[str], max_len: int = MAX_LEN) -> np.ndarray:
    """[B, max_len, 35] one-hot, zero rows past the end of each string."""
    x = np.zeros((len(smiles_list), max_len, len(CHARSET)), dtype=np.float32)
    for b, s in enumerate(smiles_list):
        for t, idx in enumerate(tokenize(s)[:max_len]):
            x[b, t, idx] = 1.0
    return x


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _act(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if not name or name == 'linear':
        return x
    if name == 'relu':
        return torch.relu(x)
    if name == 'selu':
        return F.selu(x)
    if name == 'tanh':
        return torch.tanh(x)
    if name == 'sigmoid':
        return torch.sigmoid(x)
    raise ValueError(f'unknown activation {name}')


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """x [B, L, Cin], w [K, Cin, Cout] ('same' padding, as Keras ChemNet)."""
    k = w.shape[0]
    pad_l = (k - 1) // 2
    xp = F.pad(x.transpose(1, 2), (pad_l, k - 1 - pad_l))
    return F.conv1d(xp, w.permute(2, 1, 0), b, stride=stride).transpose(1, 2)


def _gru_last(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
              b: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Keras-convention GRU (gates ordered z, r, h); returns last hidden.

    x [B, L, C]; wx [C, 3H]; wh [H, 3H]; b [3H] (or [2, 3H] for the
    CuDNN-compatible dual-bias layout)."""
    n_steps = x.shape[1]
    H = wh.shape[0]
    bx, bh = (b[0], b[1]) if b.dim() == 2 else (b, torch.zeros_like(b))
    gxs = x @ wx + bx
    h = x.new_zeros((x.shape[0], H))
    steps = range(n_steps - 1, -1, -1) if reverse else range(n_steps)
    for t in steps:
        gx = gxs[:, t]
        gh = h @ wh + bh
        z = torch.sigmoid(gx[:, :H] + gh[:, :H])
        r = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
        hh = torch.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
        h = z * h + (1.0 - z) * hh
    return h


def _lstm_last(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
               b: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Keras-convention LSTM (gates i, f, c, o); returns last hidden."""
    n_steps = x.shape[1]
    H = wh.shape[0]
    gxs = x @ wx
    h = x.new_zeros((x.shape[0], H))
    c = x.new_zeros((x.shape[0], H))
    steps = range(n_steps - 1, -1, -1) if reverse else range(n_steps)
    for t in steps:
        g = gxs[:, t] + h @ wh + b
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        cc = torch.tanh(g[:, 2 * H:3 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c = f * c + i * cc
        h = o * torch.tanh(c)
    return h


class ChemNet(nn.Module):
    """Spec-driven SMILES inference network (see module docstring); its
    weights are buffers named as in the checkpoint."""

    def __init__(self, spec: List[Dict], weights: Dict[str, np.ndarray]):
        super().__init__()
        self.spec = spec
        self.names = sorted(weights)
        for i, k in enumerate(self.names):
            self.register_buffer(f'w{i}', torch.as_tensor(
                np.asarray(weights[k], dtype=np.float32)))

    @classmethod
    def load(cls, path: str, device: str = 'cuda') -> 'ChemNet':
        with np.load(path, allow_pickle=False) as data:
            spec = json.loads(str(data['spec']))
            weights = {k: data[k] for k in data.files if k != 'spec'}
        return cls(spec, weights).to(device)

    @property
    def device(self) -> torch.device:
        return self.w0.device

    @torch.no_grad()
    def activations(self, smiles_list: Sequence[str],
                    batch_size: int = 128) -> np.ndarray:
        outs = []
        for i in range(0, len(smiles_list), batch_size):
            x = torch.from_numpy(featurize(smiles_list[i:i + batch_size]))
            outs.append(self(x.to(self.device)).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = {k: getattr(self, f'w{i}') for i, k in enumerate(self.names)}
        for layer in self.spec:
            kind = layer['kind']
            if kind == 'conv1d':
                x = _act(_conv1d(x, w[layer['w']], w[layer['b']],
                                 layer.get('stride', 1)),
                         layer.get('act'))
            elif kind == 'maxpool':
                size = layer['size']
                L = (x.shape[1] // size) * size
                x = x[:, :L].reshape(x.shape[0], L // size, size,
                                     x.shape[2]).amax(dim=2)
            elif kind == 'gru':
                x = _gru_last(x, w[layer['wx']], w[layer['wh']], w[layer['b']])
            elif kind == 'bigru':
                fwd = _gru_last(x, w[layer['wx_fwd']], w[layer['wh_fwd']],
                                w[layer['b_fwd']])
                bwd = _gru_last(x, w[layer['wx_bwd']], w[layer['wh_bwd']],
                                w[layer['b_bwd']], reverse=True)
                x = torch.cat([fwd, bwd], dim=-1)
            elif kind == 'lstm':
                x = _lstm_last(x, w[layer['wx']], w[layer['wh']], w[layer['b']])
            elif kind == 'dense':
                x = _act(x @ w[layer['w']] + w[layer['b']], layer.get('act'))
            else:
                raise ValueError(f'unknown layer kind {kind}')
        if x.dim() != 2:
            raise ValueError('spec must end with a [B, D] activation layer '
                             f'(got shape {tuple(x.shape)})')
        return x


def frechet_distance(act1: np.ndarray, act2: np.ndarray) -> float:
    """Fréchet distance between Gaussian fits of two activation sets."""
    from scipy import linalg
    mu1, mu2 = act1.mean(0), act2.mean(0)
    s1 = np.cov(act1, rowvar=False) + 1e-6 * np.eye(act1.shape[1])
    s2 = np.cov(act2, rowvar=False) + 1e-6 * np.eye(act2.shape[1])
    covmean = linalg.sqrtm(s1 @ s2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    d2 = float(((mu1 - mu2) ** 2).sum() + np.trace(s1 + s2 - 2 * covmean))
    return max(d2, 0.0)


def compute_fcd(gen: Sequence[Optional[str]], ref: Sequence[str],
                ckpt_path: str, device: str = 'cuda') -> float:
    """FCD between the valid generated SMILES and the reference set using
    the supplied ChemNet checkpoint, run on ``device``."""
    net = ChemNet.load(ckpt_path, device)
    gen_valid = [s for s in gen if s]
    if len(gen_valid) < 2 or len(ref) < 2:
        return float('nan')
    return frechet_distance(net.activations(gen_valid),
                            net.activations(list(ref)))


def random_checkpoint(path: str, seed: int = 0, hidden: int = 64,
                      out_dim: int = 128) -> str:
    """Write a small randomly-initialised checkpoint in the documented
    format (unit-test fixture + executable format documentation).  The
    layer shapes mirror the official ChemNet topology (conv stack → GRU →
    dense penultimate layer) at reduced width."""
    rng = np.random.default_rng(seed)
    C = len(CHARSET)

    def r(*shape):
        return rng.normal(0, 0.1, size=shape).astype(np.float32)

    spec = [
        {'kind': 'conv1d', 'w': 'c1_w', 'b': 'c1_b', 'stride': 2, 'act': 'selu'},
        {'kind': 'conv1d', 'w': 'c2_w', 'b': 'c2_b', 'stride': 2, 'act': 'selu'},
        {'kind': 'gru', 'wx': 'g_wx', 'wh': 'g_wh', 'b': 'g_b'},
        {'kind': 'dense', 'w': 'd_w', 'b': 'd_b', 'act': 'selu'},
    ]
    weights = {
        'c1_w': r(9, C, 32), 'c1_b': r(32),
        'c2_w': r(5, 32, 32), 'c2_b': r(32),
        'g_wx': r(32, 3 * hidden), 'g_wh': r(hidden, 3 * hidden),
        'g_b': r(3 * hidden),
        'd_w': r(hidden, out_dim), 'd_b': r(out_dim),
    }
    np.savez(path, spec=np.array(json.dumps(spec)), **weights)
    return path
