"""Frontend HTTP server + date-utility tests."""

import json
import struct
import urllib.request

import numpy as np
import pytest

from mops_jax.frontend import serve
from mops_jax.utils.dates import (YMD, make_forward_month_pairs, render_name,
                                  time_gap_seconds)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    out = tmp_path_factory.mktemp("outputs")
    # a tiny pathline binary for the viewer route
    with open(out / "pathline.bin", "wb") as f:
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<i", 2))
        f.write(np.array([[10.0, 20.0], [11.0, 21.0]], "<f8").tobytes())
        f.write(np.array([[0.1, 0.2, 0.3], [0.1, 0.2, 0.3]], "<f8").tobytes())
    srv = serve(port=0, output_dir=str(out), browse_root=str(out),
                background=True)
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def test_status(server):
    code, body = _get(server + "/api/status")
    assert code == 200
    data = json.loads(body)
    assert data["status"] == "ok" and data["n_devices"] >= 1


def test_viewer_page(server):
    code, body = _get(server + "/")
    assert code == 200 and b"pathline viewer" in body


def test_outputs_serving_and_traversal_guard(server):
    code, body = _get(server + "/outputs/pathline.bin")
    assert code == 200 and struct.unpack("<i", body[:4])[0] == 1
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server + "/outputs/../../../etc/passwd")
    assert e.value.code in (403, 404)


def test_browse(server):
    code, body = _get(server + "/api/browse")
    data = json.loads(body)
    assert any(f["name"] == "pathline.bin" for f in data["files"])


def test_task_api_dry_run(server):
    req = urllib.request.Request(
        server + "/api/remapping",
        data=json.dumps({"request": "remap at depth of 15 m",
                         "dry_run": True}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=20) as r:
        data = json.loads(r.read())
    assert data["success"] and data["task"] == "remapping"
    assert data["config"]["fixed_depth"] == 15.0


def test_task_api_rejects_empty(server):
    req = urllib.request.Request(
        server + "/api/remapping", data=b"{}",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400


def test_dates():
    d = YMD.parse("0003-02-15")
    assert d.to_int() == 30215
    assert str(d.next_month()) == "0003-03-15"
    assert time_gap_seconds(YMD(1, 1, 1), YMD(1, 1, 2)) == 86400
    assert time_gap_seconds(YMD(4, 2, 1), YMD(4, 3, 1)) == 29 * 86400  # leap
    pairs = make_forward_month_pairs(YMD(1, 11), YMD(2, 2))
    assert [(str(a), str(b)) for a, b in pairs] == [
        ("0001-11-01", "0001-12-01"),
        ("0001-12-01", "0002-01-01"),
        ("0002-01-01", "0002-02-01")]
    assert render_name("ocean.hist.{year}-{month}.nc", YMD(2, 3)) == \
        "ocean.hist.0002-03.nc"
