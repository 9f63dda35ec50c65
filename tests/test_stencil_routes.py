"""The XLA routes that serve batched 2D/3D structured solves and the
fit_kappa grad steps, checked against the float64 dense reference: the
batched fixed-trip facade solves (Dirichlet, natural, custom mask) at
odd, non-square and formerly padded widths, the grad steps with their
warm-start state contract, and their gradients."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from difffe_tpu.mesh import FEMesh
from difffe_tpu.ops.stencil import (StructuredGrid, kappa_lu_from_elements,
                                    kappa_mse_grad_step_2d,
                                    solve_poisson_structured)
from difffe_tpu.ops.stencil3d import (StructuredGrid3, choose_3d_path,
                                      kappa_mse_grad_step_3d,
                                      solve_poisson_structured_3d,
                                      solve_poisson_structured_3d_batched)
from difffe_tpu.solver import solve_poisson, solve_poisson_batched


def _dense(mesh, k, f, **kw):
    return np.asarray(solve_poisson(mesh, k, f, method="dense", **kw))


def _problem2d(nx, ny, B, seed=0):
    mesh = FEMesh.rectangle(nx, ny)
    rng = np.random.default_rng(seed)
    kB = jnp.asarray(rng.uniform(0.8, 1.6, (B, mesh.n_elements)))
    fB = jnp.asarray(rng.normal(size=(B, mesh.n_nodes)))
    return mesh, kB, fB


class TestBatchedFixedTrip2D:
    """solve_poisson_batched(..., cg_tol=0, cg_maxiter=k) on rectangles:
    per-scenario PCG under vmap (α/β per scenario)."""

    @pytest.mark.parametrize("nx,ny,B", [(12, 12, 1), (8, 8, 5),
                                         (7, 5, 3), (13, 9, 2),
                                         (127, 3, 2)])
    def test_matches_dense_f64(self, nx, ny, B):
        mesh, kB, fB = _problem2d(nx, ny, B)
        uB = solve_poisson_batched(mesh, kB, fB, cg_tol=0.0,
                                   cg_maxiter=4 * (nx + ny) + 64)
        for b in range(B):
            np.testing.assert_allclose(np.asarray(uB[b]),
                                       _dense(mesh, kB[b], fB[b]),
                                       atol=1e-9)

    def test_manufactured_accuracy(self):
        n = 16
        mesh = FEMesh.rectangle(n, n)
        x, y = mesh.nodes[:, 0], mesh.nodes[:, 1]
        f = 2 * math.pi ** 2 * jnp.sin(math.pi * x) * jnp.sin(math.pi * y)
        u = solve_poisson_batched(mesh, jnp.ones((2, mesh.n_elements)),
                                  jnp.stack([f, f]), cg_tol=0.0,
                                  cg_maxiter=300)
        exact = jnp.sin(math.pi * x) * jnp.sin(math.pi * y)
        assert float(jnp.max(jnp.abs(u - exact))) < 2e-2

    def test_batched_equals_single_scenario_solves(self):
        mesh, kB, fB = _problem2d(9, 6, 4, seed=1)
        uB = solve_poisson_batched(mesh, kB, fB, cg_tol=0.0, cg_maxiter=20)
        for b in range(4):
            u1 = solve_poisson(mesh, kB[b], fB[b], cg_tol=0.0,
                               cg_maxiter=20)
            np.testing.assert_allclose(np.asarray(uB[b]), np.asarray(u1),
                                       rtol=1e-12, atol=1e-14)

    def test_gradient_matches_dense(self):
        mesh, kB, fB = _problem2d(8, 8, 3, seed=2)

        def loss(k, **kw):
            return jnp.sum(solve_poisson_batched(mesh, k, fB, **kw) ** 2)

        g = jax.grad(lambda k: loss(k, cg_tol=0.0, cg_maxiter=200))(kB)
        gd = jax.grad(lambda k: loss(k, method="dense"))(kB)
        np.testing.assert_allclose(np.asarray(g), np.asarray(gd),
                                   rtol=1e-6, atol=1e-12)

    def test_fixed_iters_past_convergence_no_nan(self):
        mesh, kB, fB = _problem2d(6, 6, 3, seed=3)
        u = solve_poisson_batched(mesh, kB, fB, cg_tol=0.0, cg_maxiter=500)
        assert np.isfinite(np.asarray(u)).all()

    @pytest.mark.parametrize("nx,ny", [(8, 8), (7, 5)])
    def test_natural_bc_batched_matches_dense(self, nx, ny):
        from difffe_tpu.ops.neumann import boundary_edges, edge_flux_load
        full = FEMesh.rectangle(nx, ny)
        left = jnp.isclose(full.nodes[:, 0], 0.0)
        mesh = dataclasses.replace(full, bc_mask=left.astype(full.dtype),
                                   bc_values=jnp.zeros(full.n_nodes))
        right = boundary_edges(
            mesh, predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        rng = np.random.default_rng(4)
        B = 3
        nmB = edge_flux_load(mesh, right,
                             jnp.asarray(rng.normal(size=(B, mesh.n_nodes))))
        kB = jnp.asarray(rng.uniform(0.8, 1.5, (B, mesh.n_elements)))
        fB = jnp.asarray(rng.normal(size=(B, mesh.n_nodes)))
        uB = solve_poisson_batched(mesh, kB, fB, neumann=nmB, cg_tol=0.0,
                                   cg_maxiter=300)
        for b in range(B):
            np.testing.assert_allclose(
                np.asarray(uB[b]), _dense(mesh, kB[b], fB[b],
                                          neumann=nmB[b]), atol=1e-8)

    def test_custom_mask_batched_matches_dense(self):
        full = FEMesh.rectangle(9, 7)
        pin = full.n_nodes // 2 + 1
        mesh = dataclasses.replace(
            full, bc_mask=full.bc_mask.at[pin].set(1.0),
            bc_values=full.bc_values.at[pin].set(-0.4))
        rng = np.random.default_rng(5)
        kB = jnp.asarray(rng.uniform(0.8, 1.5, (2, mesh.n_elements)))
        fB = jnp.ones((2, mesh.n_nodes))
        uB = solve_poisson_batched(mesh, kB, fB, cg_tol=0.0, cg_maxiter=200)
        for b in range(2):
            np.testing.assert_allclose(np.asarray(uB[b]),
                                       _dense(mesh, kB[b], fB[b]),
                                       atol=1e-9)
        assert abs(float(uB[0, pin]) + 0.4) < 1e-12


def _step_problem(n=8, B=3, seed=0, dtype=jnp.float64, ny=None):
    ny = n if ny is None else ny
    grid = StructuredGrid.unit(n, ny)
    H, W = grid.node_shape
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    kl = 1.0 + jax.random.uniform(k1, (B, ny, n), dtype)
    ku = 1.0 + jax.random.uniform(k2, (B, ny, n), dtype)
    f = jnp.ones((B, H, W), dtype)
    g = (0.1 * jnp.arange(H * W, dtype=dtype) / (H * W)).reshape(H, W)
    g = g * 0  # factory Dirichlet values; overwritten below when needed
    u_data = 0.05 * jax.random.normal(k3, (B, H, W), dtype)
    return grid, (kl, ku), f, g, u_data


class TestGradStep2D:
    def test_matches_autodiff_of_vmapped_solve(self):
        grid, klu, f, g, ud = _step_problem(8, 4)
        B, H, W = f.shape

        def loss(kl):
            u = jax.vmap(lambda a, b, c: solve_poisson_structured(
                grid, (a, b), c, g, 0.0, 150))(kl, klu[1], f)
            return jnp.mean((u - ud) ** 2)

        l_ref, g_ref = jax.value_and_grad(loss)(klu[0])
        lp, (gl, _) = kappa_mse_grad_step_2d(grid, klu, f, g, ud, 150)
        np.testing.assert_allclose(float(lp.sum() / (B * H * W)),
                                   float(l_ref), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(gl), np.asarray(g_ref),
                                   rtol=1e-8, atol=1e-16)

    def test_unbatched_kappa_and_nonzero_g(self):
        grid, (kl, ku), f, _, ud = _step_problem(7, 2, seed=1, ny=5)
        H, W = grid.node_shape
        yy, xx = jnp.meshgrid(jnp.linspace(0, 1, H), jnp.linspace(0, 1, W),
                              indexing="ij")
        g = 0.3 * xx + 0.1 * yy
        k0 = (kl[0], 2.0 * ku[0])

        def loss(a):
            u = jax.vmap(lambda c: solve_poisson_structured(
                grid, (a, k0[1]), c, g, 0.0, 200))(f)
            return jnp.mean((u - ud) ** 2)

        _, (gl, gu) = kappa_mse_grad_step_2d(grid, k0, f, g, ud, 200)
        assert gl.shape == k0[0].shape and gu.shape == k0[1].shape
        np.testing.assert_allclose(np.asarray(gl),
                                   np.asarray(jax.grad(loss)(k0[0])),
                                   rtol=1e-8, atol=1e-16)

    def test_per_scenario_equals_single_scenario_steps(self):
        """Per-scenario α/β: each batch member's step equals its own
        unbatched step at a fixed short trip count."""
        grid, klu, f, g, ud = _step_problem(9, 3, seed=2, ny=6)
        B, H, W = f.shape
        lp, (gl, gu) = kappa_mse_grad_step_2d(grid, klu, f, g, ud, 7,
                                              scale=1.0)
        for b in range(B):
            lp1, (gl1, gu1) = kappa_mse_grad_step_2d(
                grid, (klu[0][b:b + 1], klu[1][b:b + 1]), f[b:b + 1], g,
                ud[b:b + 1], 7, scale=1.0)
            np.testing.assert_allclose(float(lp[b]), float(lp1[0]),
                                       rtol=1e-12)
            np.testing.assert_allclose(np.asarray(gl[b]),
                                       np.asarray(gl1[0]), rtol=1e-10,
                                       atol=1e-16)

    def test_gradient_matches_dense_f64(self):
        mesh = FEMesh.rectangle(6, 5)
        grid = mesh.grid
        H, W = grid.node_shape
        rng = np.random.default_rng(6)
        ke = jnp.asarray(rng.uniform(0.7, 1.6, (2, mesh.n_elements)))
        f = jnp.asarray(rng.normal(size=(2, mesh.n_nodes)))
        ud = jnp.asarray(rng.normal(size=(2, mesh.n_nodes))) * 0.01
        _, (gl, gu) = kappa_mse_grad_step_2d(
            grid, kappa_lu_from_elements(grid, ke), f.reshape(2, H, W),
            mesh.bc_values.reshape(H, W), ud.reshape(2, H, W), 200,
            scale=1.0)
        g = jnp.stack([gl, gu], axis=-1).reshape(2, mesh.n_elements)
        gd = jax.grad(lambda k: 0.5 * jnp.sum((solve_poisson_batched(
            mesh, k, f, method="dense") - ud) ** 2))(ke)
        np.testing.assert_allclose(np.asarray(g), np.asarray(gd),
                                   rtol=1e-7, atol=1e-14)


class TestWarmStart2D:
    def test_warm_state_seeds_both_solves(self):
        grid, klu, f, g, ud = _step_problem(16, 2, seed=3,
                                            dtype=jnp.float32)
        _, (g_ref, _) = kappa_mse_grad_step_2d(grid, klu, f, g, ud, 128)
        _, _, state = kappa_mse_grad_step_2d(grid, klu, f, g, ud, 128,
                                             return_state=True)
        _, (g_warm, _) = kappa_mse_grad_step_2d(grid, klu, f, g, ud, 4,
                                                warm_state=state)
        _, (g_cold, _) = kappa_mse_grad_step_2d(grid, klu, f, g, ud, 4)
        ref = np.asarray(g_ref)
        err_warm = np.max(np.abs(np.asarray(g_warm) - ref))
        err_cold = np.max(np.abs(np.asarray(g_cold) - ref))
        assert err_warm < 1e-5 * np.max(np.abs(ref)) + 1e-12
        assert err_warm < 0.01 * err_cold

    def test_warm_sgd_loop_matches_cold_recovery(self):
        """An SGD loop at 12 warm iterations reaches the loss of 96 cold
        ones after the same steps — the basis of the warm policy."""
        n, B = 16, 2
        grid = StructuredGrid.unit(n, n)
        kt = 1.2 + 0.6 * jax.random.uniform(jax.random.PRNGKey(5),
                                            (B, n, n), jnp.float32)
        f = jnp.ones((B, n + 1, n + 1), jnp.float32)
        g = jnp.zeros((n + 1, n + 1), jnp.float32)
        ud = jax.vmap(lambda a, c: solve_poisson_structured(
            grid, (a, a), c, g, 0.0, 128))(kt, f)

        def run(iters, warm, steps=25, lr=2000.0):
            k = jnp.ones((B, n, n), jnp.float32)
            state, lp = None, None
            for _ in range(steps):
                lp, (gl, gu), state = kappa_mse_grad_step_2d(
                    grid, (k, k), f, g, ud, iters,
                    warm_state=state if warm else None, return_state=True)
                k = k - lr * (gl + gu)
            return float(lp.sum())

        assert run(12, True) < 4.0 * run(96, False) + 1e-12

    def test_fit_kappa_2d_warm_beats_cold_at_same_iters(self):
        mesh = FEMesh.rectangle(8, 8, dtype=jnp.float32)
        f = jnp.broadcast_to(10 * jnp.prod(jnp.sin(jnp.pi * mesh.nodes),
                                           axis=1), (3, mesh.n_nodes))
        kt = 1.2 + 0.6 * jax.random.uniform(jax.random.PRNGKey(2),
                                            (3, mesh.n_elements),
                                            jnp.float32)
        ud = solve_poisson_batched(mesh, kt, f, cg_tol=0.0, cg_maxiter=200)
        _, warm = fit_kappa_(mesh, f, ud, iters=4, warm=True)
        _, cold = fit_kappa_(mesh, f, ud, iters=4, warm=False)
        assert warm["eval_loss"] < cold["eval_loss"]


def fit_kappa_(mesh, f, ud, **kw):
    from difffe_tpu.inverse import fit_kappa
    return fit_kappa(mesh, f, ud, steps=30, **kw)


def _setup3d(n=4, B=3, seed=0, dtype=jnp.float64, grid=None):
    grid = StructuredGrid3.unit(n, n, n) if grid is None else grid
    shp = grid.node_shape
    zs = [jnp.linspace(0, 1, s, dtype=dtype) for s in shp]
    zz, yy, xx = jnp.meshgrid(*zs, indexing="ij")
    pi = jnp.pi
    f = 3 * pi ** 2 * jnp.sin(pi * xx) * jnp.sin(pi * yy) * jnp.sin(pi * zz)
    fB = jnp.broadcast_to(f, (B,) + shp)
    g0 = jnp.zeros(shp, dtype)
    kB = 1.0 + jax.random.uniform(jax.random.PRNGKey(seed),
                                  (B, grid.n_elements), dtype)
    return grid, fB, g0, kB


def _box_mesh(grid):
    return FEMesh.box(grid.nx, grid.ny, grid.nz)


class TestBatched3D:
    def test_batchminor_matches_dense_f64(self):
        grid, fB, g0, kB = _setup3d(3, B=3)
        mesh = _box_mesh(grid)
        u = solve_poisson_structured_3d_batched(grid, kB, fB, g0, 0.0, 120)
        for b in range(3):
            np.testing.assert_allclose(
                np.asarray(u[b]).ravel(),
                _dense(mesh, kB[b], fB[b].ravel()), atol=1e-9)

    def test_single_scenario_unbatched(self):
        grid, fB, g0, kB = _setup3d(3, B=1)
        u = solve_poisson_structured_3d(grid, kB[0], fB[0], g0, 0.0, 120)
        assert u.shape == grid.node_shape
        np.testing.assert_allclose(
            np.asarray(u).ravel(),
            _dense(_box_mesh(grid), kB[0], fB[0].ravel()), atol=1e-9)

    @pytest.mark.parametrize("B", [4, 127, 128])
    def test_layouts_agree(self, B):
        """choose_3d_path's two layouts give the same iterates."""
        grid, fB, g0, kB = _setup3d(2, B=B)
        u_bm = solve_poisson_structured_3d_batched(grid, kB, fB, g0, 0.0, 9)
        u_path = choose_3d_path(grid, B)(kB, fB, g0, 0.0, 9)
        np.testing.assert_allclose(np.asarray(u_path), np.asarray(u_bm),
                                   rtol=1e-12, atol=1e-14)

    def test_anisotropic_spacing(self):
        grid = StructuredGrid3(nx=4, ny=5, nz=3, hx=0.25, hy=0.2,
                               hz=1.0 / 3.0)
        mesh = FEMesh.box(4, 5, 3)
        f = jnp.ones(grid.node_shape)
        k = 1.0 + 0.5 * jax.random.uniform(jax.random.PRNGKey(2),
                                           (grid.n_elements,))
        u = solve_poisson_structured_3d(grid, k, f, jnp.zeros_like(f),
                                        0.0, 150)
        np.testing.assert_allclose(np.asarray(u).ravel(),
                                   _dense(mesh, k, f.ravel()), atol=1e-9)

    def test_kappa_f_gradients_match_dense(self):
        grid, fB, g0, kB = _setup3d(3, B=2)
        mesh = _box_mesh(grid)
        ud = solve_poisson_structured_3d_batched(grid, kB, fB, g0, 0.0,
                                                 150) + 0.01

        def loss(k, f):
            u = solve_poisson_structured_3d_batched(grid, k, f, g0, 0.0,
                                                    120)
            return jnp.mean((u - ud) ** 2)

        def loss_dense(k, f):
            u = jax.vmap(lambda kk, ff: solve_poisson(
                mesh, kk, ff.ravel(), method="dense"))(k, f)
            return jnp.mean((u.reshape(ud.shape) - ud) ** 2)

        g = jax.grad(loss, argnums=(0, 1))(kB, fB)
        gd = jax.grad(loss_dense, argnums=(0, 1))(kB, fB)
        np.testing.assert_allclose(np.asarray(g[0]), np.asarray(gd[0]),
                                   rtol=1e-7, atol=1e-14)
        np.testing.assert_allclose(np.asarray(g[1]), np.asarray(gd[1]),
                                   rtol=1e-7, atol=1e-14)


class TestGradStep3D:
    def test_matches_autodiff(self):
        grid, fB, g0, kB = _setup3d(3, B=3)
        ud = solve_poisson_structured_3d_batched(grid, kB, fB, g0, 0.0,
                                                 150) + 0.01

        def loss(k):
            u = solve_poisson_structured_3d_batched(grid, k, fB, g0, 0.0,
                                                    120)
            return jnp.mean((u - ud) ** 2)

        L, G = kappa_mse_grad_step_3d(grid, kB, fB, g0, ud, 120)
        L_ref, G_ref = jax.value_and_grad(loss)(kB)
        np.testing.assert_allclose(float(L), float(L_ref), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(G), np.asarray(G_ref),
                                   rtol=1e-9, atol=1e-18)

    def test_warm_state_threads(self):
        grid, fB, g0, kB = _setup3d(3, B=3, dtype=jnp.float32)
        ud = solve_poisson_structured_3d_batched(grid, kB, fB, g0, 0.0,
                                                 150) + 0.01
        _, _, state = kappa_mse_grad_step_3d(grid, kB, fB, g0, ud, 60,
                                             return_state=True)
        _, g_warm = kappa_mse_grad_step_3d(grid, kB, fB, g0, ud, 8,
                                           warm_state=state)
        _, g_deep = kappa_mse_grad_step_3d(grid, kB, fB, g0, ud, 120)
        np.testing.assert_allclose(np.asarray(g_warm), np.asarray(g_deep),
                                   atol=1e-6)

    def test_cube_shaped_kappa(self):
        grid, fB, g0, kB = _setup3d(2, B=2)
        ud = jnp.zeros_like(fB)
        k6 = kB.reshape((2, grid.nz, grid.ny, grid.nx, 6))
        _, G = kappa_mse_grad_step_3d(grid, kB, fB, g0, ud, 30)
        _, G6 = kappa_mse_grad_step_3d(grid, k6, fB, g0, ud, 30)
        assert G6.shape == k6.shape
        np.testing.assert_allclose(np.asarray(G6).reshape(G.shape),
                                   np.asarray(G), rtol=1e-12)

    @pytest.mark.parametrize("n,iters", [(4, 32), (16, 32), (17, 100),
                                         (32, 100)])
    def test_fit_kappa_3d_iteration_policy(self, n, iters, monkeypatch):
        """The κ-error-safe policy: 32 iterations up to 16³, 100 beyond
        (the loop itself is stubbed — only the choice is checked)."""
        from difffe_tpu import inverse
        seen = {}

        def fake_loop(grid, it, warm, lr, steps):
            seen["iters"] = it
            return lambda k, fg, g0, ug: (k, jnp.zeros((steps,)))

        monkeypatch.setattr(inverse, "_build_loop_3d", fake_loop)
        mesh = FEMesh.box(n, 2, 2)
        f = jnp.zeros((1, mesh.n_nodes))
        _, info = inverse.fit_kappa(mesh, f, f, steps=1, eval_final=False)
        assert info["iters"] == seen["iters"] == iters
        assert info["path"] == "stencil3d_batchminor"
