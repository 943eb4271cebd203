"""ChemBERTa-style SMILES-transformer property-regression baseline
(counterpart of ``ggpm_tpu/models/chemberta.py``; reference
chemberta_pr2_fine_tune.py).

A RoBERTa-like encoder over an atom-level SMILES tokenizer with a pooled
two-output head regressing HOMO and LUMO, trained on their MAE with Adam,
continuous exponential decay and early stopping.  The modules follow
flax's: ``LayerNorm`` with eps 1e-6, the tanh ``gelu``, attention with the
query scaled by 1/√head_dim, masked logits at ``finfo(float32).min`` and
its dropout mask shared over batch and heads, the pooler
``tanh(Dense(x[:, 0]))``.  Attention is plain PyTorch products and
softmax (the JAX package computes it with flax ops, no Pallas kernel).
Dropout draws from an explicit generator.  ``bridge.chemberta_from_flax``
/ ``chemberta_to_flax`` carry params between the packages; a checkpoint
(``save_chemberta``) is the JAX package's pickle of the flax tree and the
tokenizer's JSON, which each package reads.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_TOKEN_RE = re.compile(
    r'(\[[^\]]*\]|Br|Cl|Si|Se|se|si|@@|@|%\d{2}|[A-Za-z0-9=#:+\-()/\\.*$])')

PAD, BOS, EOS, UNK = 0, 1, 2, 3
LN_EPS = 1e-6           # flax LayerNorm's


class SmilesTokenizer:
    """Atom-level SMILES tokenizer (role of the reference's BPE
    tokenizer): ids 0–3 are PAD, BOS, EOS and UNK, then the tokens of the
    training SMILES in sorted order."""

    def __init__(self, vocab: Optional[Dict[str, int]] = None):
        self.vocab = vocab or {}

    @classmethod
    def build(cls, smiles_list: Sequence[str]) -> 'SmilesTokenizer':
        toks = {}
        for s in smiles_list:
            for t in _TOKEN_RE.findall(s.strip()):
                toks[t] = toks.get(t, 0) + 1
        return cls({t: i + 4 for i, t in enumerate(sorted(toks))})

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + 4

    def encode(self, smiles: str, max_len: int = 256) -> np.ndarray:
        ids = [BOS] + [self.vocab.get(t, UNK)
                       for t in _TOKEN_RE.findall(smiles.strip())] + [EOS]
        ids = ids[:max_len]
        out = np.full(max_len, PAD, dtype=np.int32)
        out[:len(ids)] = ids
        return out

    def encode_batch(self, smiles_list: Sequence[str], max_len: int = 256
                     ) -> np.ndarray:
        return np.stack([self.encode(s, max_len) for s in smiles_list])


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator], shape=None
            ) -> torch.Tensor:
    """flax ``Dropout``: keep each entry with probability ``1 - rate``
    (drawn over ``shape``, broadcast to ``x``'s) and scale it by
    ``1 / (1 - rate)``."""
    if not training or rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(shape or x.shape, generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` of a sequence with itself:
    ``query``, ``key``, ``value`` and ``out`` hold its kernels [H, heads,
    head_dim] and [heads, head_dim, H] as ``Linear`` weights [H, H]."""

    def __init__(self, hidden: int, heads: int, dropout_rate: float = 0.1):
        super().__init__()
        if hidden % heads:
            raise ValueError(f'hidden {hidden} is not a multiple of '
                             f'{heads} heads')
        self.heads = heads
        self.dropout_rate = dropout_rate
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, h = x.shape
        d = h // self.heads
        q = self.query(x).view(b, n, self.heads, d) / math.sqrt(d)
        k = self.key(x).view(b, n, self.heads, d)
        v = self.value(x).view(b, n, self.heads, d)
        w = torch.einsum('bqhd,bkhd->bhqk', q, k)
        w = torch.where(mask, w, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        # the mask is drawn once for every batch row and head
        w = dropout(w, self.dropout_rate, self.training, generator,
                    shape=(1, 1, n, n))
        o = torch.einsum('bhqk,bkhd->bqhd', w, v).reshape(b, n, h)
        return self.out(o)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer: attention and a tanh-gelu MLP, each with a
    residual and dropout."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ln0 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.attn = SelfAttention(hidden, heads, dropout_rate)
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.mlp0 = nn.Linear(hidden, mlp_dim)
        self.mlp1 = nn.Linear(mlp_dim, hidden)

    def forward(self, x, mask, generator=None):
        a = self.attn(self.ln0(x), mask, generator)
        x = x + dropout(a, self.dropout_rate, self.training, generator)
        m = self.mlp1(nn.functional.gelu(self.mlp0(self.ln1(x)),
                                         approximate='tanh'))
        return x + dropout(m, self.dropout_rate, self.training, generator)


class ChemBertaForPR2(nn.Module):
    """SMILES transformer + two-output regression head (reference
    ``ChemBertaForPR2``, chemberta_pr2_fine_tune.py:27-68).  Dropout is on
    in training mode (``model.train()``), drawn from ``generator``."""

    def __init__(self, vocab_size: int, hidden: int = 384, heads: int = 6,
                 layers: int = 6, mlp_dim: int = 1536, max_len: int = 256,
                 head_hidden: Tuple[int, ...] = (256,),
                 dropout: float = 0.1):
        super().__init__()
        self.max_len = max_len
        self.dropout_rate = dropout
        self.tok_embed = nn.Embedding(vocab_size, hidden)
        self.pos_embed = nn.Embedding(max_len, hidden)
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(hidden, heads, mlp_dim, dropout)
            for _ in range(layers)])
        self.ln = nn.LayerNorm(hidden, eps=LN_EPS)
        self.pooler = nn.Linear(hidden, hidden)
        dims = [hidden, *head_hidden]
        self.head = nn.ModuleList([nn.Linear(a, b)
                                   for a, b in zip(dims, dims[1:])])
        self.out = nn.Linear(dims[-1], 2)

    def forward(self, tokens: torch.Tensor,
                homo_labels: Optional[torch.Tensor] = None,
                lumo_labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Predictions [B, 2]; with labels, ``(loss, metrics)``: the loss is
        ``homo_mae + lumo_mae``."""
        mask = (tokens != PAD)[:, None, None, :]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.tok_embed(tokens) + self.pos_embed(pos)[None]
        x = dropout(x, self.dropout_rate, self.training, generator)
        for layer in self.layers:
            x = layer(x, mask, generator)
        x = self.ln(x)
        h = torch.tanh(self.pooler(x[:, 0]))
        for dense in self.head:
            h = dropout(torch.relu(dense(h)), self.dropout_rate,
                        self.training, generator)
        out = self.out(h)
        if homo_labels is None:
            return out
        homo_err = out[:, 0] - homo_labels
        lumo_err = out[:, 1] - lumo_labels
        homo_mae, lumo_mae = homo_err.abs().mean(), lumo_err.abs().mean()
        metrics = {'homo_mae': homo_mae, 'homo_mse': homo_err.square().mean(),
                   'lumo_mae': lumo_mae, 'lumo_mse': lumo_err.square().mean()}
        return homo_mae + lumo_mae, metrics


# -- checkpoints -------------------------------------------------------------

class ParamsUnpickler(pickle.Unpickler):
    """Loads a pickled param tree (nested dicts of numpy arrays, as either
    package writes it); refuses any other global."""

    def find_class(self, module, name):
        from ..data.dataset import _SHARD_GLOBALS
        if module.split('.')[0] == 'numpy' and (module, name) in \
                _SHARD_GLOBALS:
            return _SHARD_GLOBALS[(module, name)]
        raise pickle.UnpicklingError(
            f'a param pickle may not name {module}.{name}')


def read_params_pickle(path: str) -> dict:
    with open(path, 'rb') as f:
        return ParamsUnpickler(f).load()


def save_chemberta(path_prefix: str, model: ChemBertaForPR2,
                   tok: SmilesTokenizer) -> None:
    """The JAX package's checkpoint of a ChemBERTa: the flax param tree
    pickled (``<prefix>.params.pkl``) and the tokenizer's vocab as JSON
    (``<prefix>.tokenizer.json``)."""
    from ..bridge import chemberta_to_flax
    with open(path_prefix + '.params.pkl', 'wb') as f:
        pickle.dump(chemberta_to_flax(model), f)
    with open(path_prefix + '.tokenizer.json', 'w') as f:
        json.dump(tok.vocab, f)


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat):
    tree: dict = {}
    for path, v in flat.items():
        cur = tree
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return tree


# HF FlaxRoberta encoder-layer leaves -> the flax module's (JAX :231-250)
_MHA = 'MultiHeadDotProductAttention_0'
_HF_LAYER = {
    **{f'attention/self/{n}/{leaf}': (_MHA, n, leaf)
       for n in ('query', 'key', 'value') for leaf in ('kernel', 'bias')},
    'attention/output/dense/kernel': (_MHA, 'out', 'kernel'),
    'attention/output/dense/bias': (_MHA, 'out', 'bias'),
    'attention/output/LayerNorm/scale': ('LayerNorm_0', 'scale'),
    'attention/output/LayerNorm/bias': ('LayerNorm_0', 'bias'),
    'intermediate/dense/kernel': ('Dense_0', 'kernel'),
    'intermediate/dense/bias': ('Dense_0', 'bias'),
    'output/dense/kernel': ('Dense_1', 'kernel'),
    'output/dense/bias': ('Dense_1', 'bias'),
    'output/LayerNorm/scale': ('LayerNorm_1', 'scale'),
    'output/LayerNorm/bias': ('LayerNorm_1', 'bias'),
}


def _hf_to_ours(path: Tuple[str, ...]) -> List[Tuple[str, ...]]:
    p = '/'.join(path)
    if 'encoder/layer/' in p:
        parts = path[path.index('layer') + 1:]
        rest = '/'.join(parts[1:])
        if rest in _HF_LAYER:
            return [('params', f'TransformerEncoderLayer_{parts[0]}') +
                    _HF_LAYER[rest]]
    elif p == 'embeddings/position_embeddings/embedding':
        return [('params', 'Embed_1', 'embedding')]
    return []


def load_pretrained_backbone(model: ChemBertaForPR2, pretrained_dir: str,
                             log=print) -> Tuple[ChemBertaForPR2, int]:
    """Load backbone weights from a local checkpoint directory into
    ``model`` where path and shape match (the reference ``copy_model``
    semantics, nnutils.py:13-62); returns the model and the number of
    leaves transferred.

    Two formats: either package's ``save_chemberta`` output
    (``chemberta.params.pkl``), and a HuggingFace Flax RoBERTa checkpoint
    (``flax_model.msgpack``): its encoder layers (attention q/k/v/out,
    FFN, LayerNorms) and position embeddings.  Word embeddings are not
    transferred: the HF BPE ids are not the atom-level tokenizer's."""
    from ..bridge import chemberta_from_flax, chemberta_to_flax, \
        msgpack_restore
    native = os.path.join(pretrained_dir, 'chemberta.params.pkl')
    hf = os.path.join(pretrained_dir, 'flax_model.msgpack')
    flat_tgt = _flatten(chemberta_to_flax(model))
    n = 0
    if os.path.exists(native):
        flat_src = _flatten(read_params_pickle(native))
        merged = {}
        for k, v in flat_tgt.items():
            s = flat_src.get(k)
            if s is not None and np.shape(s) == np.shape(v):
                merged[k] = np.asarray(s)
                n += 1
            else:
                merged[k] = v
        log(f'loaded {n}/{len(flat_tgt)} leaves from native checkpoint')
    elif os.path.exists(hf):
        with open(hf, 'rb') as f:
            src = msgpack_restore(f.read())
        merged = dict(flat_tgt)
        for spath, sval in _flatten(src.get('roberta', src)).items():
            for tpath in _hf_to_ours(spath):
                tval = merged.get(tpath)
                if tval is None:
                    continue
                sarr = np.asarray(sval)
                tshape = np.shape(tval)
                # HF stores attention kernels as [H, H]; flax's are
                # [H, heads, head_dim] and [heads, head_dim, H]
                if sarr.shape != tshape and sarr.size == int(np.prod(tshape)):
                    sarr = sarr.reshape(tshape)
                if sarr.shape == tshape:
                    merged[tpath] = sarr
                    n += 1
        log(f'loaded {n}/{len(flat_tgt)} leaves from HF flax checkpoint '
            '(word embeddings intentionally not transferred)')
    else:
        log(f'no recognised checkpoint in {pretrained_dir}; '
            'training from scratch')
        return model, 0
    chemberta_from_flax(model, _unflatten(merged))
    return model, n


# -- training -----------------------------------------------------------------

def batches(data: List[list], tok: SmilesTokenizer, batch_size: int,
            max_len: int = 256) -> List[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]]:
    """``(tokens, homo, lumo)`` of each full batch of ``data`` rows
    ``[smiles, homo, lumo]`` (the tail is dropped, as the JAX package
    does)."""
    out = []
    for i in range(0, len(data) - batch_size + 1, batch_size):
        chunk = data[i:i + batch_size]
        out.append((tok.encode_batch([r[0] for r in chunk], max_len),
                    np.array([r[1] for r in chunk], dtype=np.float32),
                    np.array([r[2] for r in chunk], dtype=np.float32)))
    return out


def optimizer(lr: float, anneal_rate: float, steps: int):
    """The JAX package's chain: ``clip_by_global_norm(1.0)`` then Adam on
    ``optax.exponential_decay(lr, steps, anneal_rate)`` (continuous)."""
    from ..train.optim import make_optimizer
    return make_optimizer(lr=lr, clip_norm=1.0, anneal_rate=anneal_rate,
                          steps_per_epoch=max(steps, 1), staircase=False)


def to_device(batch, device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(x, device=device) for x in batch)


def evaluate(model: ChemBertaForPR2, val_b, device) -> Tuple[float, dict]:
    """Mean loss and metrics over ``val_b`` without dropout."""
    model.eval()
    losses, metrics = [], []
    with torch.no_grad():
        for b in val_b:
            loss, m = model(*to_device(b, device))
            losses.append(float(loss))
            metrics.append({k: float(v) for k, v in m.items()})
    return float(np.mean(losses)), {k: float(np.mean([m[k] for m in metrics]))
                                    for k in metrics[0]}


def train_chemberta(train_data: List[list], val_data: List[list],
                    epochs: int = 10, batch_size: int = 16, lr: float = 1e-4,
                    anneal_rate: float = 0.9, patience: int = 5,
                    max_len: int = 256, seed: int = 0,
                    model_kwargs: Optional[dict] = None,
                    pretrained_dir: Optional[str] = None,
                    ckpt_path: str = 'runs/chemberta.best', log=print,
                    device: str = 'cuda'
                    ) -> Tuple[ChemBertaForPR2, SmilesTokenizer]:
    """Fine-tuning loop (reference chemberta_pr2_fine_tune.py:91-193):
    per-epoch validation and early stopping on the validation loss; the
    model ends with the best validation loss's weights (restored from
    ``ckpt_path``).  The init is the port's flax-style one from a
    generator seeded with ``seed`` (no pretrained weights are fetched),
    which also draws the dropout."""
    from ..bridge import chemberta_from_flax, chemberta_to_flax
    from ..train.checkpoint import EarlyStopping, load_params
    from .vae import init_params

    tok = SmilesTokenizer.build([r[0] for r in train_data])
    model = ChemBertaForPR2(vocab_size=tok.vocab_size, max_len=max_len,
                            **(model_kwargs or {}))
    init_params(model, torch.Generator().manual_seed(seed))
    if pretrained_dir:
        load_pretrained_backbone(model, pretrained_dir, log)
    model.to(device)
    train_b, val_b = (batches(d, tok, batch_size, max_len)
                      for d in (train_data, val_data))
    state = optimizer(lr, anneal_rate, len(train_b)).attach(
        list(model.parameters()))
    gen = torch.Generator(device=device).manual_seed(seed)
    early = EarlyStopping(patience=patience, path=ckpt_path)
    for epoch in range(epochs):
        model.train()
        for b in train_b:
            for p in state.params:
                p.grad = None
            loss, _ = model(*to_device(b, device), generator=gen)
            loss.backward()
            state.step()
        if val_b:
            vl, vm = evaluate(model, val_b, device)
            log(f'[epoch {epoch}] val loss {vl:.4f} ' +
                ' '.join(f'{k}={v:.4f}' for k, v in vm.items()))
            early(vl, chemberta_to_flax(model))
            if early.early_stop:
                log('Early stopping.')
                break
    if val_b and os.path.exists(early.path):
        chemberta_from_flax(model, load_params(chemberta_to_flax(model),
                                               early.path))
    return model, tok
