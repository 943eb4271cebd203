"""HTTP JSON serving of a loaded model (counterpart of ``ggpm_tpu/serve.py``).

    server = GgpmServer(model, vocab)          # model moved to cuda
    httpd = server.start(port=0)               # a free port, daemon thread
    port = httpd.server_address[1]
    ...
    server.stop()

    POST /encode       {"smiles": [...]}      → {"latents": [[...], ...]}
    POST /reconstruct  {"smiles": [...]}      → {"smiles": [...]}
    POST /sample       {"n": 8, "seed": 0}    → {"smiles": [...]}
    POST /properties   {"smiles": [...]}      → {"homo": [...], "lumo": [...]}
    POST /optimize     {"smiles": [...], "homo": [...], "lumo": [...],
                        "policy": "hard"}     → {"smiles", "homo", "lumo"}
    GET  /health                              → status

``/optimize`` searches the latents of the molecules against the target
HOMO/LUMO values (``latent.control.LatentOptimizer`` with the policy's
defaults; ``GgpmServer.optimize`` takes its other settings as keywords),
predicts the properties at the searched latents and decodes them through
the turbo path.  A model of the hier family (``is_hier``) encodes its
molecules' atom level too and decodes through the exact hier path
(``models/decode.py:decode_best``); ``/properties`` and ``/optimize`` need
property heads (``prop-opt``, ``hier-prop-opt``).  A failed request
answers 500 with ``{"error": str(e)}``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from .data.batching import to_model_batch
from .graph.mol_graph import tensorize
from .graph.vocab import PairVocab, common_atom_vocab
from .latent.control import LatentOptimizer
from .models.api import encode as _encode
from .models.decode import decode_best, is_hier, sample_prior


class GgpmServer:
    def __init__(self, model, vocab: PairVocab, avocab=common_atom_vocab,
                 max_decode_step: int = 150, device: str = 'cuda'):
        self.model = model.eval().to(device)
        self.vocab = vocab
        self.avocab = avocab
        self.max_decode_step = max_decode_step
        self.is_hier = is_hier(model)
        self.lock = threading.Lock()   # one request on the model at a time
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # the last /optimize's LatentOptimizer.stats(), for profiling
        self.search_stats: Optional[dict] = None

    # -- operations --------------------------------------------------------
    def _encode_smiles(self, smiles_list) -> torch.Tensor:
        mb = tensorize([[s, None, None] for s in smiles_list],
                       self.vocab, self.avocab)
        z, _ = _encode(self.model, to_model_batch(mb, self.vocab.mask,
                                                  pad=False))
        return z

    def encode(self, smiles_list):
        return {'latents': self._encode_smiles(smiles_list).tolist()}

    def reconstruct(self, smiles_list):
        z = self._encode_smiles(smiles_list)
        _, out = decode_best(self.model, self.vocab, self.avocab, z,
                             greedy=True,
                             max_decode_step=self.max_decode_step,
                             log_steps=False)
        return {'smiles': out}

    def sample(self, n: int, seed: int = 0):
        _, out = sample_prior(self.model, self.vocab, self.avocab, n,
                              rng=np.random.default_rng(seed),
                              max_decode_step=self.max_decode_step,
                              log_steps=False)
        return {'smiles': out}

    def properties(self, smiles_list):
        z = self._encode_smiles(smiles_list)
        with torch.no_grad():
            h, l = self.model.predict_properties(z)
        return {'homo': h.tolist(), 'lumo': l.tolist()}

    def optimize(self, smiles_list, homo, lumo, policy: str = 'hard',
                 **opt_kwargs):
        z = self._encode_smiles(smiles_list)
        opt = LatentOptimizer(self.model, optimize_type=policy, **opt_kwargs)
        z_opt = opt.optimize(z, np.asarray(homo, dtype=np.float32),
                             np.asarray(lumo, dtype=np.float32))
        self.search_stats = opt.stats()
        with torch.no_grad():
            h, l = self.model.predict_properties(z_opt)
        _, out = decode_best(self.model, self.vocab, self.avocab, z_opt,
                             greedy=True,
                             max_decode_step=self.max_decode_step,
                             log_steps=False)
        return {'smiles': out, 'homo': h.tolist(), 'lumo': l.tolist()}

    # -- http --------------------------------------------------------------
    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == '/health':
                    self._reply(200, {'status': 'ok',
                                      'model': type(server.model).__name__,
                                      'vocab': list(server.vocab.size())})
                else:
                    self._reply(404, {'error': 'not found'})

            def do_POST(self):
                try:
                    n = int(self.headers.get('Content-Length', 0))
                    req = json.loads(self.rfile.read(n) or b'{}')
                    with server.lock:
                        if self.path == '/encode':
                            out = server.encode(req['smiles'])
                        elif self.path == '/reconstruct':
                            out = server.reconstruct(req['smiles'])
                        elif self.path == '/sample':
                            out = server.sample(int(req.get('n', 8)),
                                                int(req.get('seed', 0)))
                        elif self.path == '/properties':
                            out = server.properties(req['smiles'])
                        elif self.path == '/optimize':
                            # the body passes the policy only, as the JAX
                            # server's does
                            out = server.optimize(
                                req['smiles'], req['homo'], req['lumo'],
                                req.get('policy', 'hard'))
                        else:
                            self._reply(404, {'error': 'not found'})
                            return
                    self._reply(200, out)
                except Exception as e:
                    # the request fails, the server keeps running
                    self._reply(500, {'error': str(e)})

        return Handler

    def start(self, port: int = 8000, block: bool = False
              ) -> ThreadingHTTPServer:
        """Serve on all interfaces (``port=0`` takes a free port), on a
        daemon thread unless ``block``.  Returns the HTTP server; its
        ``server_address[1]`` is the bound port."""
        self._httpd = ThreadingHTTPServer(('0.0.0.0', port), self._handler())
        self._httpd.daemon_threads = True
        if block:
            self._httpd.serve_forever()
        else:
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            daemon=True)
            self._thread.start()
        return self._httpd

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            if self._thread is not None:
                self._thread.join(30)
            self._httpd = self._thread = None
