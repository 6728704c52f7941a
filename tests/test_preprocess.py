"""Preprocessing op tests vs the scalar oracle + analytic checks."""

import numpy as np
import jax.numpy as jnp

import mops_jax as mt
from mops_jax import solution
from mops_jax.oracle import oracle_preprocess


def test_cell_center_ztop_bottom_depth():
    lt = np.array([[10.0, 20.0, 30.0]])
    bd = np.array([60.0])
    z = np.asarray(solution.cell_center_ztop(jnp.asarray(lt), jnp.asarray(bd)))
    # z[2] = -60 + 30 = -30; z[1] = -60+50 = -10; z[0] = -60+60 = 0
    np.testing.assert_allclose(z, [[0.0, -10.0, -30.0]], atol=1e-12)


def test_cell_center_ztop_surface_height():
    lt = np.array([[10.0, 20.0, 30.0]])
    ssh = np.array([2.0])
    z = np.asarray(solution.cell_center_ztop(jnp.asarray(lt),
                                             surface_height=jnp.asarray(ssh)))
    np.testing.assert_allclose(z, [[2.0, -8.0, -28.0]], atol=1e-12)


def test_cell_center_ztop_default_zero_surface():
    lt = np.array([[10.0, 20.0, 30.0]])
    z = np.asarray(solution.cell_center_ztop(jnp.asarray(lt)))
    np.testing.assert_allclose(z, [[0.0, -10.0, -30.0]], atol=1e-12)


def test_cell_to_vertex_matches_oracle(mesh, raw_fields):
    field = np.asarray(raw_fields["temperature"], dtype=np.float64)
    got = np.asarray(solution.cell_to_vertex(mesh, jnp.asarray(field),
                                             clamp_negative=True))
    want = oracle_preprocess(mesh, field, clamp_negative=True)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_cell_to_vertex_vector_matches_oracle(mesh, sol):
    cell_vel = np.asarray(sol.cell_velocity)
    got = np.asarray(solution.cell_to_vertex(mesh, jnp.asarray(cell_vel)))
    want = oracle_preprocess(mesh, cell_vel)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_velocity_zm_magnitude(mesh, raw_fields, sol):
    """ENU->XYZ preserves the horizontal speed."""
    zonal = np.asarray(raw_fields["velocityZonal"])
    merid = np.asarray(raw_fields["velocityMeridional"])
    speed_in = np.sqrt(zonal ** 2 + merid ** 2)
    speed_out = np.linalg.norm(np.asarray(sol.cell_velocity), axis=-1)
    np.testing.assert_allclose(speed_out, speed_in, rtol=1e-10)


def test_rbf_velocity_matches_scalar_oracle(mesh, raw_fields, sol):
    """Batched RBF reconstruction == the scalar Gauss-elimination oracle
    (per-cell transcription of the reference kernel, including the alpha=1.0
    override and the evaluate_rbf(1.0) rhs quirk)."""
    import jax.numpy as jnp
    from mops_jax.oracle import oracle_rbf_cell_velocity

    # synthesize edge-normal velocities by projecting the ZM cell velocity
    cx = np.asarray(mesh.cell_xyz)
    ex = np.asarray(mesh.edge_xyz)
    true_vel = np.asarray(sol.cell_velocity)
    coe = np.asarray(mesh.cells_on_edge)
    c0, c1 = coe[:, 0], coe[:, 1]
    both = (c0 >= 0) & (c1 >= 0)
    cmin = np.where(both, np.minimum(c0, c1), np.maximum(c0, c1))
    cmax = np.maximum(c0, c1)
    normal = np.where(both[:, None], cx[cmax] - cx[np.clip(cmin, 0, None)],
                      ex - cx[np.clip(cmin, 0, None)])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    v_edge = 0.5 * (true_vel[np.clip(c0, 0, None)] + true_vel[np.clip(cmax, 0, None)])
    normal_vel = np.einsum("eld,ed->el", v_edge, normal)

    rec = np.asarray(solution.cell_center_velocity_rbf(
        mesh, jnp.asarray(normal_vel)))
    for cell in (0, 7, 123, 400):
        for layer in (0, 3):
            want = oracle_rbf_cell_velocity(mesh, normal_vel, cell, layer)
            np.testing.assert_allclose(rec[cell, layer], want,
                                       rtol=1e-8, atol=1e-10)


def test_preprocess_bundles_attrs(sol):
    assert set(sol.cell_attrs) == {"temperature", "salinity"}
    assert set(sol.vertex_attrs) == {"temperature", "salinity"}
    assert sol.vertex_ztop.shape == (sol.vertex_velocity.shape[0], sol.n_layers)
    assert sol.vertex_vert_velocity.shape[1] == sol.n_layers + 1
