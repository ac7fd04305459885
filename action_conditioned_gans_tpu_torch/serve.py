"""Minimal HTTP inference server over a port Predictor (port of ``serve.py``).

Stdlib only, the same wire protocol as the JAX package's server:

* ``GET /healthz``  -> JSON: model geometry, predictor type, device name.
* ``POST /predict`` -> body npz ``{frame (B,H,W,C), action (B,A)[, state]}``,
  response npz ``{frames (B,H,W,C)}``.
* ``POST /rollout`` -> body npz ``{frame0, actions (B,T,A)[, states]}``,
  response npz ``{frames (B,T,H,W,C)}``.

``?encoding=uint8`` on either POST quantizes the response frames with the
data pipeline's transform (``round((clip(f,-1,1)+1)*127.5)``); the client
helpers decode it back to float32. All device work, the device->host copy
included, runs under one lock, so requests never share the card.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict
from urllib.parse import parse_qs

import numpy as np
import torch

_NPZ = "application/x-npz"
# Refuse request bodies beyond this (413): the handler buffers the body.
_MAX_BODY = 2 << 30


def _load_npz(body: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _dump_npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def encode_frames(frames: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8, the TFRecord writers' transform."""
    return np.round((np.clip(frames, -1, 1) + 1) * 127.5).astype(np.uint8)


def decode_frames(frames: np.ndarray) -> np.ndarray:
    """uint8 -> [-1,1] float32, the readers' normalize."""
    return frames.astype(np.float32) / 255.0 * 2.0 - 1.0


def predictor_meta(predictor) -> Dict[str, Any]:
    """Geometry and device facts for /healthz."""
    dev = predictor.device
    m = predictor.cfg.model
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "backend": type(predictor).__name__,
        "image_size": m.image_size,
        "image_channels": m.image_channels,
        "action_dim": m.action_dim,
        "state_dim": m.state_dim,
    }


def to_host(out: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy; bfloat16 becomes float32 (exact), since numpy
    has no bfloat16 and the wire dtype must not leak the compute dtype."""
    out = out.cpu()
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.numpy()


def make_server(predictor, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``port=0`` picks a free one
    (read it back from ``server.server_port``)."""
    lock = threading.Lock()
    meta = predictor_meta(predictor)

    class Handler(BaseHTTPRequestHandler):
        server_version = "acgan-serve/1"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"ok": True, **meta})
            else:
                self._send_json(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):
            # Always drain the body before answering: with HTTP/1.1
            # keep-alive, unread bytes would be parsed as the next request.
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                n = -1
            if n < 0:
                self.close_connection = True
                self._send_json(400, {"error": "bad Content-Length"})
                return
            if n > _MAX_BODY:
                self.close_connection = True
                self._send_json(413, {"error": f"body of {n} bytes exceeds {_MAX_BODY}"})
                return
            raw = self.rfile.read(n)
            path, _, query = self.path.partition("?")
            if path not in ("/predict", "/rollout"):
                self._send_json(404, {"error": f"unknown path {path!r}"})
                return
            encoding = parse_qs(query).get("encoding", ["float32"])[-1]
            if encoding not in ("float32", "uint8"):
                self._send_json(400, {"error": f"unknown encoding {encoding!r} (float32|uint8)"})
                return
            try:
                arrays = _load_npz(raw)
            except Exception as e:
                self._send_json(400, {"error": f"body is not an npz archive: {e}"})
                return
            try:
                # One request on the device at a time; the copy to the host
                # stays inside the lock, since CUDA work is asynchronous.
                with lock:
                    if path == "/predict":
                        out = predictor.predict(
                            arrays["frame"], arrays["action"], arrays.get("state")
                        )
                    else:
                        out = predictor.rollout(
                            arrays.get("frame0", arrays.get("frame")),
                            arrays["actions"],
                            arrays.get("states"),
                        )
                    out = to_host(out)
                if encoding == "uint8":
                    out = encode_frames(out)
                body = _dump_npz(frames=out)
            except KeyError as e:
                self._send_json(400, {"error": f"missing input array {e}"})
                return
            except (ValueError, TypeError, IndexError) as e:
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — a 500 beats a reset
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, body, _NPZ)

    srv = ThreadingHTTPServer((host, port), Handler)
    # A wedged client connection must not block server shutdown.
    srv.daemon_threads = True
    srv.predictor_meta = meta
    return srv


def build_predictor(args, cfg):
    """CLI glue: ``--artifact foo.npz`` loads the portable weights archive,
    any other ``--artifact`` an AOT program (``aot.AotPredictor``, no model
    code); with no artifact the live Predictor restores ``--workdir``'s
    latest checkpoint (its EMA weights with ``--ema``)."""
    from action_conditioned_gans_tpu_torch.infer import Predictor

    device = getattr(args, "device", None)
    artifact = getattr(args, "artifact", None)
    if artifact:
        if artifact.endswith(".npz"):
            return Predictor.from_npz(artifact, cfg=cfg, device=device)
        from action_conditioned_gans_tpu_torch.aot import AotPredictor

        return AotPredictor(artifact, device=device)
    return Predictor.from_checkpoint(cfg, args.workdir, use_ema=bool(getattr(args, "ema", False)),
                                     device=device)


def serve_forever(predictor, host: str, port: int) -> None:
    srv = make_server(predictor, host, port)
    print(
        json.dumps(
            {"serving": f"http://{srv.server_address[0]}:{srv.server_port}", **srv.predictor_meta}
        ),
        flush=True,
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


# -- tiny stdlib client -------------------------------------------------------


def _post(url: str, arrays: Dict[str, np.ndarray]) -> np.ndarray:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=_dump_npz(**arrays), headers={"Content-Type": _NPZ})
    try:
        with urllib.request.urlopen(req) as resp:
            frames = _load_npz(resp.read())["frames"]
        if frames.dtype == np.uint8:  # ?encoding=uint8 response
            frames = decode_frames(frames)
        return frames
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace")
        try:
            detail = json.loads(detail)["error"]
        except (ValueError, KeyError):
            pass
        raise RuntimeError(f"server returned {e.code}: {detail}") from None


def _route(base_url: str, path: str, encoding: str) -> str:
    url = base_url.rstrip("/") + path
    return url + (f"?encoding={encoding}" if encoding != "float32" else "")


def client_predict(base_url: str, frame, action, state=None, encoding: str = "float32") -> np.ndarray:
    arrays = {"frame": np.asarray(frame), "action": np.asarray(action)}
    if state is not None:
        arrays["state"] = np.asarray(state)
    return _post(_route(base_url, "/predict", encoding), arrays)


def client_rollout(base_url: str, frame0, actions, states=None, encoding: str = "float32") -> np.ndarray:
    arrays = {"frame0": np.asarray(frame0), "actions": np.asarray(actions)}
    if states is not None:
        arrays["states"] = np.asarray(states)
    return _post(_route(base_url, "/rollout", encoding), arrays)
