"""IO tests: NetCDF roundtrip (classic + HDF5), YAML stream config, writers.

Mirrors the reference test/test_io.cpp scenarios (YAML parse, NetCDF
roundtrip) but against locally generated fixtures: no network egress exists
here, so a synthetic mesh is written to NetCDF and read back instead of
downloading the SOMA mesh."""

import os

import numpy as np
import pytest

import mops_jax as mt
from mops_jax.io import MPASOReader, NetCDFFile, StreamConfig
from mops_jax.io.image import (save_png, save_trajectories_text,
                               save_trajectories_vtp, save_vti,
                               export_pathline_binary)


def _write_mesh_nc3(path, mesh, raw, n_layers):
    """Write mesh + one timestep in MPAS NetCDF layout via scipy (NetCDF-3)."""
    from scipy.io import netcdf_file
    f = netcdf_file(path, "w")
    nc_, nv_, ne_, me = mesh.n_cells, mesh.n_vertices, mesh.n_edges, mesh.max_edges
    f.createDimension("nCells", nc_)
    f.createDimension("nVertices", nv_)
    f.createDimension("nEdges", ne_)
    f.createDimension("maxEdges", me)
    f.createDimension("vertexDegree", 3)
    f.createDimension("TWO", 2)
    f.createDimension("nVertLevels", n_layers)
    f.createDimension("nVertLevelsP1", n_layers + 1)
    f.createDimension("Time", 1)

    def put(name, dims, data, typ="d"):
        v = f.createVariable(name, typ, dims)
        v[:] = data

    cx = np.asarray(mesh.cell_xyz)
    vx = np.asarray(mesh.vertex_xyz)
    ex = np.asarray(mesh.edge_xyz)
    put("xCell", ("nCells",), cx[:, 0]); put("yCell", ("nCells",), cx[:, 1])
    put("zCell", ("nCells",), cx[:, 2])
    put("xVertex", ("nVertices",), vx[:, 0]); put("yVertex", ("nVertices",), vx[:, 1])
    put("zVertex", ("nVertices",), vx[:, 2])
    put("xEdge", ("nEdges",), ex[:, 0]); put("yEdge", ("nEdges",), ex[:, 1])
    put("zEdge", ("nEdges",), ex[:, 2])
    put("nEdgesOnCell", ("nCells",), np.asarray(mesh.n_edges_on_cell), "i")

    def back_1based(arr):
        a = np.asarray(arr).astype(np.int32)
        return np.where(a < 0, 0, a + 1)

    put("verticesOnCell", ("nCells", "maxEdges"),
        back_1based(mesh.vertices_on_cell), "i")
    put("cellsOnCell", ("nCells", "maxEdges"),
        back_1based(mesh.cells_on_cell), "i")
    put("cellsOnVertex", ("nVertices", "vertexDegree"),
        back_1based(mesh.cells_on_vertex), "i")
    put("edgesOnCell", ("nCells", "maxEdges"),
        back_1based(mesh.edges_on_cell), "i")
    put("cellsOnEdge", ("nEdges", "TWO"), back_1based(mesh.cells_on_edge), "i")
    put("verticesOnEdge", ("nEdges", "TWO"),
        back_1based(mesh.vertices_on_edge), "i")
    put("refBottomDepth", ("nVertLevels",),
        np.linspace(100, 4000, n_layers))

    put("bottomDepth", ("nCells",), raw["bottomDepth"])
    put("layerThickness", ("Time", "nCells", "nVertLevels"),
        raw["layerThickness"][None])
    put("velocityZonal", ("Time", "nCells", "nVertLevels"),
        raw["velocityZonal"][None])
    put("velocityMeridional", ("Time", "nCells", "nVertLevels"),
        raw["velocityMeridional"][None])
    put("vertVelocityTop", ("Time", "nCells", "nVertLevelsP1"),
        raw["vertVelocityTop"][None])
    put("temperature", ("Time", "nCells", "nVertLevels"),
        raw["temperature"][None])
    f.close()


@pytest.fixture(scope="module")
def nc_fixture(tmp_path_factory, mesh, raw_fields):
    d = tmp_path_factory.mktemp("data")
    path = str(d / "synth_mesh.nc")
    _write_mesh_nc3(path, mesh, {k: np.asarray(v) for k, v in raw_fields.items()},
                    n_layers=6)
    yaml_path = str(d / "stream.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"""
stream:
  name: synth
  path_prefix: "{d}"
  substreams:
    - name: mesh
      format: netcdf
      filenames: "synth_mesh.nc"
      static: true
    - name: data
      format: netcdf
      filenames: "synth_*.nc"
      vars:
        - name: velocityZonal
          possible_names: [velocityZonal]
        - name: temperature
          optional: true
""")
    return path, yaml_path


def test_netcdf3_read(nc_fixture):
    path, _ = nc_fixture
    with NetCDFFile(path) as nc:
        assert nc.has("xCell")
        assert nc.dimension_size("nVertLevels") == 6
        lt = nc.read_timestep("layerThickness", 0)
        assert lt.ndim == 2
        assert lt.dtype == np.float64


def test_hdf5_read(tmp_path):
    import h5py
    p = str(tmp_path / "t.h5")
    with h5py.File(p, "w") as f:
        f["xCell"] = np.arange(5.0, dtype=np.float32)
    with NetCDFFile(p) as nc:
        assert nc.has("xCell")
        arr = nc.read("xCell")
        assert arr.dtype == np.float64     # float promotion


def test_stream_config_and_reader_roundtrip(nc_fixture, mesh, raw_fields):
    _, yaml_path = nc_fixture
    cfg = StreamConfig.parse(yaml_path)
    assert cfg.substream("mesh").static
    assert len(cfg.substream("data").filenames) == 1   # wildcard resolved

    reader = MPASOReader(cfg)
    m2 = reader.read_mesh()
    np.testing.assert_allclose(np.asarray(m2.cell_xyz),
                               np.asarray(mesh.cell_xyz))
    np.testing.assert_array_equal(np.asarray(m2.vertices_on_cell),
                                  np.asarray(mesh.vertices_on_cell))
    m2.validate()

    raw = reader.read_solution(0)
    np.testing.assert_allclose(raw["layerThickness"],
                               np.asarray(raw_fields["layerThickness"]))
    np.testing.assert_allclose(raw["velocityZonal"],
                               np.asarray(raw_fields["velocityZonal"]))
    assert "temperature" in raw
    # end-to-end: the NetCDF-loaded mesh+solution preprocesses cleanly
    sol = mt.preprocess(m2, raw)
    assert sol.n_layers == 6


def test_writers(tmp_path, mesh, sol):
    img = np.random.default_rng(0).normal(size=(8, 12, 3))
    img[0, 0] = np.nan
    save_png(str(tmp_path / "x.png"), img[..., 0])
    save_vti(str(tmp_path / "x.vti"), [img], ["velocity"])
    assert (tmp_path / "x.png").exists()
    assert "ImageData" in (tmp_path / "x.vti").read_text()

    lines = [mt.TrajectoryLine(
        line_id=0, points=np.ones((3, 3)), velocity=np.zeros((3, 3)),
        temperature=np.zeros(3), salinity=np.zeros(3),
        last_point=np.ones(3), duration=1.0, timestamp=1.0, depth=10.0)]
    save_trajectories_vtp(str(tmp_path / "t.vtp"), lines)
    save_trajectories_text(str(tmp_path / "t.txt"), lines)
    export_pathline_binary(str(tmp_path / "t.bin"), lines)
    assert "PolyData" in (tmp_path / "t.vtp").read_text()
    assert (tmp_path / "t.bin").stat().st_size > 4


def test_real_soma_mesh_golden_when_online(tmp_path):
    """Download the reference's own SOMA 32-km mesh
    (reference test/test_io.cpp:33-50) and run a golden streamline on
    real MPAS-O data.  The test reaches the network only when
    MOPS_ONLINE_TESTS=1 is set; otherwise it skips without trying."""
    import os
    import urllib.error
    import urllib.request
    if os.environ.get("MOPS_ONLINE_TESTS") != "1":
        pytest.skip("network tests run only with MOPS_ONLINE_TESTS=1")
    url = ("https://web.lcrc.anl.gov/public/e3sm/inputdata/ocn/mpas-o/"
           "SOMA_32km/ocean.SOMA.32km.151027.nc")
    nc_path = tmp_path / "soma32.nc"
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            nc_path.write_bytes(r.read())
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        pytest.skip(f"SOMA download unavailable: {e}")

    from mops_jax.io.reader import MPASOReader, StreamConfig
    yaml_path = tmp_path / "soma.yaml"
    yaml_path.write_text(f"""
stream:
  name: soma
  path_prefix: "{tmp_path}"
  substreams:
    - name: mesh
      format: netcdf
      filenames: "soma32.nc"
      static: true
    - name: data
      format: netcdf
      filenames: "soma32.nc"
""")
    reader = MPASOReader(StreamConfig.parse(str(yaml_path)))
    mesh = reader.read_mesh()
    assert mesh.n_cells > 1000
    mesh.validate()
