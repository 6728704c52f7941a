"""Web front-end: HTTP API + trajectory viewer.

Re-design of the reference Flask server (reference
frontend/backend_server.py:27-325) on the Python stdlib http.server (this
image has no Flask):

  POST /api/remapping   {"request": "...", "yaml_path"?, "data_folder"?,
                         "dry_run"?}  -> route + generate (+run) a job
  GET  /api/browse?path=DIR           -> list .nc/.yaml files
  GET  /api/status                    -> health + device info
  GET  /outputs/<path>                -> generated images / trajectories
  GET  /                              -> the self-contained canvas viewer
                                         (frontend/viewer.html; the reference
                                         uses a deck.gl page, which needs CDN
                                         access this environment lacks)
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_HERE = os.path.dirname(__file__)


def _json_bytes(obj) -> bytes:
    return json.dumps(obj).encode()


class _Handler(BaseHTTPRequestHandler):
    output_dir = "agent_outputs"
    browse_root = "."

    def _send(self, code: int, body: bytes, ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet
        pass

    # -- GET ---------------------------------------------------------------
    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path in ("/", "/index.html"):
            with open(os.path.join(_HERE, "viewer.html"), "rb") as f:
                return self._send(200, f.read(), "text/html")
        if parsed.path == "/api/status":
            import jax
            dev = jax.devices()[0]
            return self._send(200, _json_bytes({
                "status": "ok",
                "device": f"{dev.platform}:{dev.device_kind}",
                "n_devices": len(jax.devices()),
            }))
        if parsed.path == "/api/browse":
            q = urllib.parse.parse_qs(parsed.query)
            path = q.get("path", [self.browse_root])[0]
            try:
                entries = sorted(os.listdir(path))
            except OSError as e:
                return self._send(400, _json_bytes({"error": str(e)}))
            files = [{"name": n,
                      "dir": os.path.isdir(os.path.join(path, n))}
                     for n in entries
                     if os.path.isdir(os.path.join(path, n))
                     or n.endswith((".nc", ".yaml", ".yml", ".png", ".bin",
                                    ".vtp", ".vti"))]
            return self._send(200, _json_bytes({"path": path, "files": files}))
        if parsed.path.startswith("/outputs/"):
            rel = os.path.normpath(parsed.path[len("/outputs/"):])
            if rel.startswith(".."):
                return self._send(403, _json_bytes({"error": "forbidden"}))
            full = os.path.join(self.output_dir, rel)
            if not os.path.isfile(full):
                return self._send(404, _json_bytes({"error": "not found"}))
            ctype = ("image/png" if full.endswith(".png")
                     else "application/octet-stream")
            with open(full, "rb") as f:
                return self._send(200, f.read(), ctype)
        return self._send(404, _json_bytes({"error": "unknown route"}))

    # -- POST --------------------------------------------------------------
    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        length = int(self.headers.get("Content-Length", 0))
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return self._send(400, _json_bytes({"error": "invalid JSON"}))

        if parsed.path == "/api/remapping" or parsed.path == "/api/task":
            user_request = payload.get("request", "")
            if not user_request:
                return self._send(400, _json_bytes(
                    {"success": False, "error": "No request provided"}))
            from ..agent import generate_job, run_agent
            overrides = {}
            if payload.get("yaml_path"):
                overrides["yaml_path"] = payload["yaml_path"]
            if payload.get("data_folder"):
                from ..agent import generate_stream_yaml
                ypath = os.path.join(self.output_dir, "auto.yaml")
                os.makedirs(self.output_dir, exist_ok=True)
                try:
                    generate_stream_yaml(payload["data_folder"], ypath)
                    overrides["yaml_path"] = ypath
                except Exception as e:
                    return self._send(400, _json_bytes(
                        {"success": False, "error": f"yaml generation: {e}"}))
            dry = bool(payload.get("dry_run", True))
            try:
                task, script, cfg = generate_job(
                    user_request, output_dir=self.output_dir,
                    overrides=overrides)
                rc = 0
                if not dry:
                    import subprocess, sys
                    rc = subprocess.run([sys.executable, script]).returncode
                images = [f for f in os.listdir(cfg.get("output_subdir", "."))
                          if f.endswith(".png")] \
                    if os.path.isdir(cfg.get("output_subdir", "")) else []
                return self._send(200, _json_bytes({
                    "success": rc == 0, "task": task, "script": script,
                    "config": cfg, "images": images}))
            except Exception as e:
                return self._send(500, _json_bytes(
                    {"success": False, "error": str(e)}))
        return self._send(404, _json_bytes({"error": "unknown route"}))


def create_server(host: str = "127.0.0.1", port: int = 8808,
                  output_dir: str = "agent_outputs",
                  browse_root: str = ".") -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,),
                   {"output_dir": output_dir, "browse_root": browse_root})
    return ThreadingHTTPServer((host, port), handler)


def serve(host: str = "127.0.0.1", port: int = 8808,
          output_dir: str = "agent_outputs", browse_root: str = ".",
          background: bool = False):
    srv = create_server(host, port, output_dir, browse_root)
    if background:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv
    print(f"mops_jax frontend on http://{host}:{port}")
    srv.serve_forever()


if __name__ == "__main__":
    serve()
