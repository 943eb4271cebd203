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
    GET  /health                              → status

``/optimize`` needs latent search, which the port does not have yet: it
answers 501.  A failed request answers 500 with ``{"error": str(e)}``.
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
from .models.api import encode as _encode
from .models.decode import decode_best, sample_prior

_NOT_YET = ('/optimize needs latent search, which the PyTorch port does not '
            'have yet (ROADMAP.md, queue A)')


class GgpmServer:
    def __init__(self, model, vocab: PairVocab, avocab=common_atom_vocab,
                 max_decode_step: int = 150, device: str = 'cuda'):
        self.model = model.eval().to(device)
        self.vocab = vocab
        self.avocab = avocab
        self.max_decode_step = max_decode_step
        self.lock = threading.Lock()   # one request on the model at a time
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

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
                            self._reply(501, {'error': _NOT_YET})
                            return
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
