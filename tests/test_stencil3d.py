"""7-point structured 3D stencil path (ops/stencil3d.py) vs the element
oracle (ops/assembly.py p1_tet), mirroring tests/test_stencil.py.

3D is beyond the reference (it raises for dim>2,
/root/reference/diffhe/solver.py:62-67); correctness is established
against this repo's own dense/element paths, which are themselves tested
against manufactured solutions in tests/test_solver_3d.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from difffe_tpu.mesh import FEMesh
from difffe_tpu.ops.assembly import assemble_load, local_stiffness_3d
from difffe_tpu.ops.cg import solve_poisson_cg
from difffe_tpu.ops.stencil3d import (
    OFFSETS3,
    StructuredGrid3,
    boundary_mask_box,
    load_box,
    solve_poisson_structured_3d,
    stencil3d_apply,
    stencil3d_coefficients,
    stencil3d_kappa_grad,
)


def _dense_from_elements(mesh, kappa):
    """Global dense stiffness via scatter of local_stiffness_3d (oracle)."""
    Ke = np.array(local_stiffness_3d(mesh, kappa))
    el = np.array(mesh.elements)
    N = mesh.n_nodes
    A = np.zeros((N, N))
    for e in range(el.shape[0]):
        for a in range(4):
            for b in range(4):
                A[el[e, a], el[e, b]] += Ke[e, a, b]
    return A


def _planes_from_dense(grid, A):
    """Extract the 7 stencil planes from a dense matrix (oracle form)."""
    nz1, ny1, nx1 = grid.node_shape
    C = np.zeros((7,) + grid.node_shape)
    for k, (dz, dy, dx) in enumerate(OFFSETS3):
        for z in range(nz1):
            for y in range(ny1):
                for x in range(nx1):
                    z2, y2, x2 = z + dz, y + dy, x + dx
                    if 0 <= z2 < nz1 and 0 <= y2 < ny1 and 0 <= x2 < nx1:
                        i = (z * ny1 + y) * nx1 + x
                        j = (z2 * ny1 + y2) * nx1 + x2
                        C[k, z, y, x] = A[i, j]
    return C


@pytest.mark.parametrize("dims", [(2, 2, 2), (3, 2, 4)])
def test_coefficients_match_dense_assembly(dims):
    nx, ny, nz = dims
    mesh = FEMesh.box(nx, ny, nz, dtype=jnp.float64)
    grid = StructuredGrid3.unit(nx, ny, nz)
    ne = mesh.n_elements
    rng = np.random.default_rng(0)
    kappa = jnp.asarray(rng.uniform(0.5, 2.0, ne))

    A = _dense_from_elements(mesh, kappa)
    C_oracle = _planes_from_dense(grid, A)
    C = np.array(stencil3d_coefficients(grid, kappa))
    np.testing.assert_allclose(C, C_oracle, atol=1e-12)

    # the dense matrix has NO couplings outside the 7 offsets (the Kuhn
    # 7-point property, per-tet, any kappa)
    mask = np.zeros_like(A, dtype=bool)
    nz1, ny1, nx1 = grid.node_shape
    for (dz, dy, dx) in OFFSETS3:
        for z in range(nz1):
            for y in range(ny1):
                for x in range(nx1):
                    z2, y2, x2 = z + dz, y + dy, x + dx
                    if 0 <= z2 < nz1 and 0 <= y2 < ny1 and 0 <= x2 < nx1:
                        i = (z * ny1 + y) * nx1 + x
                        j = (z2 * ny1 + y2) * nx1 + x2
                        mask[i, j] = True
    assert np.abs(A[~mask]).max() < 1e-13


def test_anisotropic_spacing_matches_dense():
    nx, ny, nz = 3, 2, 2
    mesh = FEMesh.box(nx, ny, nz, x_range=(0.0, 1.5), y_range=(0.0, 0.7),
                      z_range=(0.0, 2.6), dtype=jnp.float64)
    grid = StructuredGrid3.unit(nx, ny, nz, x_range=(0.0, 1.5),
                                y_range=(0.0, 0.7), z_range=(0.0, 2.6))
    rng = np.random.default_rng(1)
    kappa = jnp.asarray(rng.uniform(0.5, 2.0, mesh.n_elements))
    A = _dense_from_elements(mesh, kappa)
    C_oracle = _planes_from_dense(grid, A)
    C = np.array(stencil3d_coefficients(grid, kappa))
    np.testing.assert_allclose(C, C_oracle, atol=1e-12)


def test_apply_matches_dense_matvec():
    nx = ny = nz = 3
    mesh = FEMesh.box(nx, ny, nz, dtype=jnp.float64)
    grid = StructuredGrid3.unit(nx, ny, nz)
    rng = np.random.default_rng(2)
    kappa = jnp.asarray(rng.uniform(0.5, 2.0, mesh.n_elements))
    u = jnp.asarray(rng.normal(size=grid.node_shape))
    A = _dense_from_elements(mesh, kappa)
    out = stencil3d_apply(stencil3d_coefficients(grid, kappa), u)
    np.testing.assert_allclose(np.array(out).ravel(),
                               A @ np.array(u).ravel(), atol=1e-11)


def test_load_box_matches_assemble_load():
    nx, ny, nz = 3, 4, 2
    mesh = FEMesh.box(nx, ny, nz, dtype=jnp.float64)
    grid = StructuredGrid3.unit(nx, ny, nz)
    xyz = mesh.nodes
    f = jnp.sin(3.0 * xyz[:, 0]) + jnp.cos(2.0 * xyz[:, 1]) * xyz[:, 2]
    F_mesh = assemble_load(mesh, f)
    F_grid = load_box(grid, f.reshape(grid.node_shape))
    np.testing.assert_allclose(np.array(F_grid).ravel(), np.array(F_mesh),
                               atol=1e-13)


def test_solve_matches_element_cg_path():
    nx = ny = nz = 4
    mesh = FEMesh.box(nx, ny, nz, dtype=jnp.float64)
    grid = StructuredGrid3.unit(nx, ny, nz)
    rng = np.random.default_rng(3)
    kappa = jnp.asarray(rng.uniform(0.5, 2.0, mesh.n_elements))
    xyz = mesh.nodes
    pi = jnp.pi
    f_nodes = (3 * pi ** 2 * jnp.sin(pi * xyz[:, 0])
               * jnp.sin(pi * xyz[:, 1]) * jnp.sin(pi * xyz[:, 2]))
    F = assemble_load(mesh, f_nodes)
    u_el = solve_poisson_cg(mesh, kappa, F, 0.0, mesh.n_nodes)
    u_st = solve_poisson_structured_3d(
        grid, kappa, f_nodes.reshape(grid.node_shape),
        jnp.zeros(grid.node_shape))
    np.testing.assert_allclose(np.array(u_st).ravel(), np.array(u_el),
                               atol=1e-9)


def test_gradient_parity_vs_element_path():
    nx = ny = nz = 3
    mesh = FEMesh.box(nx, ny, nz, dtype=jnp.float64)
    grid = StructuredGrid3.unit(nx, ny, nz)
    rng = np.random.default_rng(4)
    kappa = jnp.asarray(rng.uniform(0.5, 2.0, mesh.n_elements))
    xyz = mesh.nodes
    f_nodes = jnp.sin(2.0 * xyz[:, 0] + 1.0) * jnp.cos(xyz[:, 1] - xyz[:, 2])
    target = jnp.asarray(rng.normal(size=mesh.n_nodes))

    def loss_el(k):
        F = assemble_load(mesh, f_nodes)
        u = solve_poisson_cg(mesh, k, F, 0.0, mesh.n_nodes)
        return jnp.mean((u - target) ** 2)

    def loss_st(k):
        u = solve_poisson_structured_3d(
            grid, k, f_nodes.reshape(grid.node_shape),
            jnp.zeros(grid.node_shape))
        return jnp.mean((u.reshape(-1) - target) ** 2)

    g_el = jax.grad(loss_el)(kappa)
    g_st = jax.grad(loss_st)(kappa)
    np.testing.assert_allclose(np.array(g_st), np.array(g_el),
                               rtol=1e-6, atol=1e-10)


def test_kappa_grad_closed_form_matches_autodiff():
    nx, ny, nz = 3, 2, 3
    grid = StructuredGrid3.unit(nx, ny, nz)
    rng = np.random.default_rng(5)
    kappa = jnp.asarray(rng.uniform(0.5, 2.0, grid.n_elements))
    lam = jnp.asarray(rng.normal(size=grid.node_shape))
    w = jnp.asarray(rng.normal(size=grid.node_shape))

    def bilinear(k):
        C = stencil3d_coefficients(grid, k)
        return jnp.sum(lam * stencil3d_apply(C, w))

    g_ad = jax.grad(bilinear)(kappa)
    g_cf = stencil3d_kappa_grad(grid, lam, w).reshape(-1)
    np.testing.assert_allclose(np.array(g_cf), np.array(g_ad), atol=1e-11)


def test_grad_f_and_g_match_autodiff_through_residual():
    nx = ny = nz = 3
    grid = StructuredGrid3.unit(nx, ny, nz)
    rng = np.random.default_rng(6)
    kappa = jnp.asarray(rng.uniform(0.5, 2.0, grid.n_elements))
    f = jnp.asarray(rng.normal(size=grid.node_shape))
    gbc = jnp.asarray(rng.normal(size=grid.node_shape))
    tgt = jnp.asarray(rng.normal(size=grid.node_shape))

    def loss(f_, g_):
        u = solve_poisson_structured_3d(grid, kappa, f_, g_)
        return jnp.mean((u - tgt) ** 2)

    gf, gg = jax.grad(loss, argnums=(0, 1))(f, gbc)

    # finite-difference spot checks on interior and boundary entries
    eps = 1e-6
    for arr, grad, idx in [(f, gf, (1, 2, 1)), (gbc, gg, (0, 1, 2)),
                           (gbc, gg, (2, 0, 1))]:
        d = jnp.zeros_like(arr).at[idx].set(eps)
        if arr is f:
            num = (loss(arr + d, gbc) - loss(arr - d, gbc)) / (2 * eps)
        else:
            num = (loss(f, arr + d) - loss(f, arr - d)) / (2 * eps)
        np.testing.assert_allclose(float(grad[idx]), float(num),
                                   rtol=1e-4, atol=1e-8)


def test_batched_vmap_and_cube_layout():
    nx = ny = nz = 3
    grid = StructuredGrid3.unit(nx, ny, nz)
    B = 4
    rng = np.random.default_rng(7)
    kappa = jnp.asarray(rng.uniform(0.5, 2.0, (B, grid.n_elements)))
    f = jnp.asarray(rng.normal(size=(B,) + grid.node_shape))
    g0 = jnp.zeros(grid.node_shape)

    solve = jax.vmap(lambda k, ff: solve_poisson_structured_3d(
        grid, k, ff, g0))
    uB = solve(kappa, f)
    for b in range(B):
        u1 = solve_poisson_structured_3d(grid, kappa[b], f[b], g0)
        np.testing.assert_allclose(np.array(uB[b]), np.array(u1),
                                   atol=1e-10)

    # cube-shaped kappa (..., nz, ny, nx, 6) gives identical results
    k_cube = kappa.reshape(B, nz, ny, nx, 6)
    u_cube = jax.vmap(lambda k, ff: solve_poisson_structured_3d(
        grid, k, ff, g0))(k_cube, f)
    np.testing.assert_allclose(np.array(u_cube), np.array(uB), atol=1e-12)

    # gradients flow through the batched solve with cube layout
    def loss(k):
        u = solve(k, f)
        return jnp.mean(u ** 2)

    g = jax.grad(loss)(kappa)
    assert g.shape == kappa.shape and bool(jnp.isfinite(g).all())


def test_boundary_mask_matches_mesh():
    nx, ny, nz = 4, 3, 2
    mesh = FEMesh.box(nx, ny, nz, dtype=jnp.float64)
    grid = StructuredGrid3.unit(nx, ny, nz)
    m = boundary_mask_box(grid, jnp.float64)
    np.testing.assert_array_equal(np.array(m).ravel(),
                                  np.array(mesh.bc_mask))


def test_batched_batch_minor_matches_vmap():
    from difffe_tpu.ops.stencil3d import (
        choose_3d_path, solve_poisson_structured_3d_batched)
    nx = ny = nz = 4
    grid = StructuredGrid3.unit(nx, ny, nz)
    B = 3
    rng = np.random.default_rng(8)
    kappa = jnp.asarray(rng.uniform(0.5, 2.0, (B, grid.n_elements)))
    f = jnp.asarray(rng.normal(size=(B,) + grid.node_shape))
    g0 = jnp.zeros(grid.node_shape)
    uV = jax.vmap(lambda k, ff: solve_poisson_structured_3d(
        grid, k, ff, g0, 0.0, 80))(kappa, f)
    uB = solve_poisson_structured_3d_batched(grid, kappa, f, g0, 0.0, 80)
    np.testing.assert_allclose(np.array(uB), np.array(uV), atol=1e-13)

    tgt = jnp.asarray(rng.normal(size=(B,) + grid.node_shape))

    def lossB(k, ff, g_):
        u = solve_poisson_structured_3d_batched(grid, k, ff, g_, 0.0, 80)
        return jnp.mean((u - tgt) ** 2)

    def lossV(k, ff, g_):
        u = jax.vmap(lambda kk, fff: solve_poisson_structured_3d(
            grid, kk, fff, g_, 0.0, 80))(k, ff)
        return jnp.mean((u - tgt) ** 2)

    gB = jax.grad(lossB, argnums=(0, 1, 2))(kappa, f, g0)
    gV = jax.grad(lossV, argnums=(0, 1, 2))(kappa, f, g0)
    for a, b in zip(gB, gV):
        np.testing.assert_allclose(np.array(a), np.array(b), atol=1e-14)

    # dispatch: both regimes return working callables
    for Bp in (3, 256):
        solve = choose_3d_path(grid, Bp)
        kk = jnp.broadcast_to(kappa[:1], (2, grid.n_elements))
        ff = jnp.broadcast_to(f[:1], (2,) + grid.node_shape)
        u = solve(kk, ff, g0, 0.0, 40)
        assert u.shape == (2,) + grid.node_shape
        assert bool(jnp.isfinite(u).all())


def test_kappa_mse_grad_step_matches_autodiff():
    from difffe_tpu.ops.stencil3d import (
        kappa_mse_grad_step_3d, solve_poisson_structured_3d_batched)
    grid = StructuredGrid3.unit(4, 4, 4)
    B = 3
    rng = np.random.default_rng(9)
    kappa = jnp.asarray(rng.uniform(0.5, 2.0, (B, grid.n_elements)))
    f = jnp.asarray(rng.normal(size=(B,) + grid.node_shape))
    g0 = jnp.zeros(grid.node_shape)
    u_data = jnp.asarray(rng.normal(size=(B,) + grid.node_shape))

    def loss_ref(kk):
        u = solve_poisson_structured_3d_batched(grid, kk, f, g0, 0.0, 125)
        return jnp.mean((u - u_data) ** 2)

    L_ref, G_ref = jax.value_and_grad(loss_ref)(kappa)
    L, G = kappa_mse_grad_step_3d(grid, kappa, f, g0, u_data, 125)
    np.testing.assert_allclose(float(L), float(L_ref), rtol=1e-12)
    np.testing.assert_allclose(np.array(G), np.array(G_ref), atol=1e-18)

    # warm state is an opaque carry: at full convergence a warm step with
    # few iterations reproduces the converged (loss, grad)
    L2, G2, st = kappa_mse_grad_step_3d(grid, kappa, f, g0, u_data, 125,
                                        return_state=True)
    L3, G3 = kappa_mse_grad_step_3d(grid, kappa, f, g0, u_data, 3,
                                    warm_state=st)
    np.testing.assert_allclose(float(L3), float(L), rtol=1e-10)
    np.testing.assert_allclose(np.array(G3), np.array(G), atol=1e-16)
