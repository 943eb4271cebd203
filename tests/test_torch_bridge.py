"""The port's weight bridge: its plain-Python msgpack reader against flax's
on the trained checkpoint, and the mapping of a flax tree into the port's
modules."""

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from ggpm_tpu_torch.bridge import (flatten, load_flax_params, load_model,
                                   msgpack_restore)
from ggpm_tpu_torch.models.vae import ModelConfig, PropOptVAE

torch.set_num_threads(1)

CKPT = 'runs/QUALITY_hopv.json.ckpt'
VOCAB = 'runs/QUALITY_hopv.json.vocab.txt'


@pytest.fixture(scope='module')
def trees():
    with open(CKPT, 'rb') as f:
        data = f.read()
    return msgpack_restore(data), serialization.msgpack_restore(data)


def test_reader_matches_flax_on_checkpoint(trees):
    ours, theirs = trees
    ours = flatten(ours)
    theirs = {'/'.join(k): v for k, v in
              traverse_util.flatten_dict(theirs).items()}
    assert list(ours) == list(theirs)
    for path, ref in theirs.items():
        got = ours[path]
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert got.tobytes() == ref.tobytes(), path


@pytest.mark.parametrize('value', [
    0, 127, 128, 255, 65535, 2 ** 32, 2 ** 63 - 1, -1, -32, -33, -2 ** 15,
    -2 ** 63, 1.5, -0.25, 3.4e38, '', 'x' * 31, 'y' * 32, 'z' * 300,
    'w' * 70000, b'', b'\x00' * 300, None, True, False, [], list(range(20)),
    {'a': {'b': [1, 'c']}}, {str(i): i for i in range(20)}])
def test_reader_decodes_msgpack_types(value):
    got = msgpack_restore(msgpack.packb(value, use_bin_type=True))
    assert got == value and type(got) is type(value)


@pytest.mark.parametrize('dtype', ['float32', 'int32', 'float64', 'int8'])
def test_reader_decodes_flax_arrays(dtype):
    tree = {'w': np.arange(24, dtype=dtype).reshape(2, 3, 4),
            's': np.zeros((0, 5), dtype=dtype)}
    got = msgpack_restore(serialization.msgpack_serialize(tree))
    for k, v in tree.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)


def test_reader_rejects_trailing_bytes():
    with pytest.raises(ValueError):
        msgpack_restore(msgpack.packb({'a': 1}) + b'\x00')


def test_mapping_of_trained_checkpoint(trees):
    """Dense kernels arrive transposed, embeddings and biases as they are;
    every leaf of the checkpoint, the decoder's included, is carried."""
    tree = trees[0]
    model = PropOptVAE(ModelConfig(hvocab_size=91, ivocab_size=380))
    assert load_flax_params(model, tree) is None
    flat = flatten(tree['params'])
    state = model.state_dict()
    p = 'vae/encoder/tree_encoder/rnn/W_f/'
    np.testing.assert_array_equal(
        state['vae.encoder.tree_encoder.rnn.W_f.weight'], flat[p + 'kernel'].T)
    np.testing.assert_array_equal(
        state['vae.encoder.tree_encoder.rnn.W_f.bias'], flat[p + 'bias'])
    np.testing.assert_array_equal(state['vae.E_c.weight'],
                                  flat['vae/E_c/embedding'])
    np.testing.assert_array_equal(
        state['property_optim.lumo_linear.Dense_1.weight'],
        flat['property_optim/lumo_linear/Dense_1/kernel'].T)
    p = 'vae/decoder/'
    np.testing.assert_array_equal(state['vae.decoder.rnn.W_i.weight'],
                                  flat[p + 'rnn/W_i/kernel'].T)
    np.testing.assert_array_equal(state['vae.decoder.clsNN.Dense_1.bias'],
                                  flat[p + 'clsNN/Dense_1/bias'])
    np.testing.assert_array_equal(state['vae.decoder.W_root.weight'],
                                  flat[p + 'W_root/kernel'].T)
    assert len(state) == len(flat) == 54
    assert {k.replace('.', '/').rsplit('/', 1)[0] for k in state} == {
        k.rsplit('/', 1)[0] for k in flat}


@pytest.mark.parametrize('leaf', [
    {'A_topo': {'kernel': np.zeros((250, 24), np.float32)}},
    {'rnn': {'W_z': {'bias': np.zeros(250, np.float32)}}},
    {'topoNN': {'Dense_2': {'kernel': np.zeros((250, 1), np.float32)}}}],
    ids=['A_topo', 'rnn/W_z', 'topoNN/Dense_2'])
def test_mapping_rejects_an_unknown_decoder_leaf(trees, leaf):
    """A decoder leaf with no port module (an attention head, a GRU gate,
    an extra layer) is an error, as any other unknown leaf."""
    model = PropOptVAE(ModelConfig(hvocab_size=91, ivocab_size=380))
    params = dict(trees[0]['params'])
    vae = dict(params['vae'])
    vae['decoder'] = {**vae['decoder'], **leaf}
    params['vae'] = vae
    with pytest.raises(ValueError, match='no port module'):
        load_flax_params(model, params)


def test_mapping_rejects_unknown_and_missing(trees):
    model = PropOptVAE(ModelConfig(hvocab_size=91, ivocab_size=380))
    params = dict(trees[0]['params'])
    with pytest.raises(ValueError):
        load_flax_params(model, {**params, 'loss_weigh': {
            'homo_log_var': np.zeros(1, np.float32)}})
    del params['property_optim']
    with pytest.raises(RuntimeError):
        load_flax_params(model, params)


def test_load_model_on_cpu():
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    assert vocab.size() == (91, 380)
    assert not model.training
    assert all(p.device.type == 'cpu' for p in model.parameters())
    assert model.vae.encoder.tree_encoder.rnn.W_i.weight.shape == (250, 520)
    assert model.vae.decoder.rnn.W_i.weight.shape == (250, 520)
    assert model.vae.decoder.W_node.weight.shape == (250, 500)
    assert model.vae.decoder.clsNN.Dense_1.weight.shape == (91, 250)
    # the embeddings are the VAE's own, tied between encoder and decoder
    assert model.vae.encoder._embed[0] is model.vae.E_c
    assert model.vae.decoder._embed == (model.vae.E_c, model.vae.E_i)
    assert model._decoder() is model.vae.decoder

