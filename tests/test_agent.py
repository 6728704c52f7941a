"""Agent routing / config-extraction / job-rendering tests."""

import json
import os

from mops_jax.agent import (extract_config, generate_job, route_request,
                            generate_stream_yaml)


def test_keyword_routing():
    assert route_request("remap the velocity to a global image").task == "remapping"
    assert route_request("draw streamlines for one snapshot").task == "streamline"
    assert route_request("particle trajectories across months").task == "pathline"
    assert route_request("do something with the ocean").task == "pathline"


def test_llm_routing_with_stub():
    llm = lambda system, user: '{"task": "streamline", "confidence": 0.9, "reason": "x"}'
    r = route_request("whatever", llm=llm)
    assert r.task == "streamline" and r.confidence == 0.9


def test_llm_failure_falls_back():
    def broken(system, user):
        raise RuntimeError("no network")
    assert route_request("remap this", llm=broken).task == "remapping"


def test_config_extraction():
    cfg = extract_config("streamline",
                         "7-day streamline at depth of 25 m, 16x16 seeds, "
                         "dt=2 min, euler, in the gulf of mexico")
    assert cfg["duration_days"] == 7
    assert cfg["fixed_depth"] == 25.0
    assert cfg["grid"] == [16, 16]
    assert cfg["delta_minutes"] == 2
    assert cfg["method"] == "euler"
    assert cfg["lat_range"] == [18.0, 31.0]


def test_generate_job_renders_runnable_python(tmp_path):
    task, path, cfg = generate_job("remap at depth of 20 m, 360x180",
                                   output_dir=str(tmp_path))
    assert task == "remapping"
    assert cfg["width"] == 360 and cfg["fixed_depth"] == 20.0
    src = open(path).read()
    compile(src, path, "exec")          # syntactically valid
    assert "run_remapping" in src
    # config sidecar written
    sidecars = [f for f in os.listdir(tmp_path) if f.startswith("config_")]
    assert len(sidecars) == 1
    json.load(open(os.path.join(tmp_path, sidecars[0])))


def test_generate_stream_yaml(tmp_path, mesh, raw_fields):
    import numpy as np
    from tests.test_io import _write_mesh_nc3
    nc = str(tmp_path / "oceanmesh.nc")
    _write_mesh_nc3(nc, mesh, {k: np.asarray(v) for k, v in raw_fields.items()},
                    n_layers=6)
    out = generate_stream_yaml(str(tmp_path), str(tmp_path / "auto.yaml"))
    text = open(out).read()
    assert "oceanmesh.nc" in text
    from mops_jax.io import StreamConfig
    cfg = StreamConfig.parse(out)
    assert cfg.substream("mesh").filenames


def test_llm_client_endpoint_resolution(monkeypatch):
    from mops_jax.agent import llm_client
    for var in ("FOUNDRY_BASE_URL", "AZURE_INFERENCE_ENDPOINT",
                "AZURE_OPENAI_ENDPOINT", "OPENAI_BASE_URL", "FOUNDRY_API_KEY",
                "AZURE_INFERENCE_API_KEY", "AZURE_OPENAI_API_KEY",
                "OPENAI_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    p, url, key = llm_client.resolve_provider()
    assert p == "openai" and url.startswith("https://api.openai.com")
    monkeypatch.setenv("AZURE_OPENAI_ENDPOINT", "https://x.azure.com")
    monkeypatch.setenv("AZURE_OPENAI_API_KEY", "k")
    p, url, key = llm_client.resolve_provider()
    assert p == "foundry" and key == "k"
    ep = llm_client.chat_endpoint(url, "foundry", "2024-02-01", "gpt4")
    assert ep == ("https://x.azure.com/openai/deployments/gpt4/"
                  "chat/completions?api-version=2024-02-01")
    ep2 = llm_client.chat_endpoint("https://api.openai.com/v1", "openai")
    assert ep2 == "https://api.openai.com/v1/chat/completions"


def test_llm_client_against_local_server():
    """Offline end-to-end: stdlib HTTP server mocks the chat API; the agent
    routes through the real urllib client (retry on a first-503)."""
    import http.server
    import json as _json
    import threading

    calls = {"n": 0}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            calls["n"] += 1
            if calls["n"] == 1:           # transient failure -> retried
                self.send_response(503)
                self.end_headers()
                self.wfile.write(b"busy")
                return
            body = self.rfile.read(int(self.headers["Content-Length"]))
            req = _json.loads(body)
            assert req["messages"][0]["role"] == "system"
            out = {"choices": [{"message": {"content":
                '{"task": "streamline", "reason": "mock"}'}}]}
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(_json.dumps(out).encode())

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        from mops_jax.agent import make_llm, route_request
        llm = make_llm(model="test-model",
                       base_url=f"http://127.0.0.1:{srv.server_port}/v1",
                       api_key="k", provider="openai")
        res = route_request("integrate some particles please", llm=llm)
        assert res.task == "streamline"
        assert calls["n"] == 2            # one 503 + one success
    finally:
        srv.shutdown()
