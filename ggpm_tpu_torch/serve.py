"""HTTP JSON serving of a loaded model (counterpart of ``ggpm_tpu/serve.py``).

    server = GgpmServer(model, vocab)          # model moved to cuda
    port = server.start(port=0)                # a free port, daemon thread
    ...
    server.stop()

    POST /encode       {"smiles": [...]}   → {"latents": [[...], ...]}
    POST /properties   {"smiles": [...]}   → {"homo": [...], "lumo": [...]}
    GET  /health                           → status

``/reconstruct``, ``/sample`` and ``/optimize`` need the decoder, which
arrives with the decode slice: they answer 501 until then.
"""

from __future__ import annotations

import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from .data.batching import to_model_batch
from .graph.mol_graph import tensorize
from .graph.vocab import PairVocab, common_atom_vocab
from .models.api import encode as _encode

DECODE_ENDPOINTS = ('/reconstruct', '/sample', '/optimize')
_NOT_YET = ('{} needs the decoder, which the PyTorch port does not have yet '
            '(ROADMAP.md, queue A: the decode slice)')


class GgpmServer:
    def __init__(self, model, vocab: PairVocab, device: str = 'cuda'):
        self.model = model.eval().to(device)
        self.vocab = vocab
        self.lock = threading.Lock()   # one request on the model at a time
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- operations --------------------------------------------------------
    def _encode_smiles(self, smiles_list) -> torch.Tensor:
        mb = tensorize([[s, None, None] for s in smiles_list],
                       self.vocab, common_atom_vocab)
        z, _ = _encode(self.model, to_model_batch(mb, self.vocab.mask,
                                                  pad=False))
        return z

    def encode(self, smiles_list):
        return {'latents': self._encode_smiles(smiles_list).tolist()}

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
                if self.path in DECODE_ENDPOINTS:
                    self._reply(501, {'error': _NOT_YET.format(self.path)})
                    return
                ops = {'/encode': server.encode,
                       '/properties': server.properties}
                if self.path not in ops:
                    self._reply(404, {'error': 'not found'})
                    return
                try:
                    n = int(self.headers.get('Content-Length', 0))
                    req = json.loads(self.rfile.read(n) or b'{}')
                    with server.lock:
                        out = ops[self.path](req['smiles'])
                except Exception:
                    # the request fails, the server keeps running
                    self._reply(500, {'error': traceback.format_exc()})
                    return
                self._reply(200, out)

        return Handler

    def start(self, port: int = 0, host: str = '127.0.0.1') -> int:
        """Serve on a daemon thread; ``port=0`` takes a free port.  Returns
        the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(30)
            self._httpd = self._thread = None
