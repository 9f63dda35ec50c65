"""Natural BCs (Neumann/Robin) + general Dirichlet masks on the 2D
structured stencil fast path (VERDICT-r4 item 4): parity with the dense
reference path, gradient flow, facade routing, and fallback."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from difffe_tpu.mesh import FEMesh
from difffe_tpu.ops.neumann import boundary_edges, edge_flux_load
from difffe_tpu.ops.robin import RobinBC, robin_edges
from difffe_tpu.solver import solve_poisson, solve_poisson_batched


def left_dirichlet_rectangle(nx, ny):
    """Unit square, Dirichlet ONLY on x=0, grid metadata KEPT."""
    full = FEMesh.rectangle(nx=nx, ny=ny)
    on_left = jnp.isclose(full.nodes[:, 0], 0.0)
    return dataclasses.replace(
        full, bc_mask=on_left.astype(full.dtype),
        bc_values=jnp.zeros(full.n_nodes, full.dtype))


class TestNeumannStructured:
    def test_linear_solution_right_flux(self):
        """−Δu=0, u|_{x=0}=0, flux 1 on x=1 → u = x, via the stencil
        route (auto)."""
        mesh = left_dirichlet_rectangle(8, 8)
        right = boundary_edges(mesh,
                               predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        nm = edge_flux_load(mesh, right, jnp.ones(mesh.n_nodes))
        u = solve_poisson(mesh, 1.0, jnp.zeros(mesh.n_nodes),
                          method="stencil", neumann=nm)
        np.testing.assert_allclose(np.asarray(u),
                                   np.asarray(mesh.nodes[:, 0]),
                                   atol=1e-9)

    def test_parity_with_dense_variable_kappa(self):
        mesh = left_dirichlet_rectangle(6, 5)
        rng = np.random.default_rng(0)
        kappa = jnp.asarray(rng.uniform(0.5, 2.0, mesh.n_elements))
        f = jnp.asarray(rng.normal(size=mesh.n_nodes))
        right = boundary_edges(mesh,
                               predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        q = jnp.asarray(rng.normal(size=mesh.n_nodes))
        nm = edge_flux_load(mesh, right, q)
        u_st = solve_poisson(mesh, kappa, f, method="stencil", neumann=nm)
        u_de = solve_poisson(mesh, kappa, f, method="dense", neumann=nm)
        np.testing.assert_allclose(np.asarray(u_st), np.asarray(u_de),
                                   atol=1e-9)

    def test_auto_routes_to_stencil(self):
        """method='auto' with a Neumann load on a grid mesh takes the
        stencil path (same answer, and the resolver says so)."""
        from difffe_tpu.solver import _resolve_method
        mesh = left_dirichlet_rectangle(6, 6)
        assert _resolve_method(mesh, "auto", kappa=1.0,
                               structured_ok=True) == "stencil"
        right = boundary_edges(mesh,
                               predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        nm = edge_flux_load(mesh, right, jnp.ones(mesh.n_nodes))
        f = jnp.ones(mesh.n_nodes)
        u_auto = solve_poisson(mesh, 1.0, f, neumann=nm)
        u_dense = solve_poisson(mesh, 1.0, f, method="dense", neumann=nm)
        np.testing.assert_allclose(np.asarray(u_auto),
                                   np.asarray(u_dense), atol=1e-9)

    def test_gradients_match_dense(self):
        """∂/∂κ and ∂/∂q agree with the dense path's autodiff."""
        mesh = left_dirichlet_rectangle(5, 4)
        rng = np.random.default_rng(1)
        kappa = jnp.asarray(rng.uniform(0.5, 2.0, mesh.n_elements))
        f = jnp.asarray(rng.normal(size=mesh.n_nodes))
        right = boundary_edges(mesh,
                               predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        q = jnp.asarray(rng.normal(size=mesh.n_nodes))

        def loss(method):
            def fn(k, qq):
                nm = edge_flux_load(mesh, right, qq)
                u = solve_poisson(mesh, k, f, method=method, neumann=nm)
                return jnp.sum(u ** 2)
            return fn

        gk_s, gq_s = jax.grad(loss("stencil"), argnums=(0, 1))(kappa, q)
        gk_d, gq_d = jax.grad(loss("dense"), argnums=(0, 1))(kappa, q)
        np.testing.assert_allclose(np.asarray(gk_s), np.asarray(gk_d),
                                   rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(np.asarray(gq_s), np.asarray(gq_d),
                                   rtol=1e-6, atol=1e-10)

    def test_batched_neumann(self):
        mesh = left_dirichlet_rectangle(6, 6)
        B = 3
        rng = np.random.default_rng(2)
        right = boundary_edges(mesh,
                               predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        qB = jnp.asarray(rng.normal(size=(B, mesh.n_nodes)))
        nmB = edge_flux_load(mesh, right, qB)
        f = jnp.ones(mesh.n_nodes)
        uB = solve_poisson_batched(mesh, 1.0, jnp.broadcast_to(
            f, (B, mesh.n_nodes)), neumann=nmB)
        assert uB.shape == (B, mesh.n_nodes)
        for i in range(B):
            u1 = solve_poisson(mesh, 1.0, f, method="dense",
                               neumann=nmB[i])
            np.testing.assert_allclose(np.asarray(uB[i]), np.asarray(u1),
                                       atol=1e-9)


class TestRobinStructured:
    def _mesh_and_robin(self, nx=6, ny=5, alpha=2.0):
        mesh = left_dirichlet_rectangle(nx, ny)
        right = boundary_edges(mesh,
                               predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        rng = np.random.default_rng(3)
        r_nodal = jnp.asarray(rng.normal(size=mesh.n_nodes))
        rb = robin_edges(mesh, right, alpha, r_nodal)
        return mesh, rb

    def test_parity_with_dense(self):
        mesh, rb = self._mesh_and_robin()
        f = jnp.ones(mesh.n_nodes)
        u_st = solve_poisson(mesh, 1.3, f, method="stencil", robin=rb)
        u_de = solve_poisson(mesh, 1.3, f, method="dense", robin=rb)
        np.testing.assert_allclose(np.asarray(u_st), np.asarray(u_de),
                                   atol=1e-9)

    def test_robin_gradients_match_dense(self):
        """Gradients to α (through vals) and r (through load) agree."""
        mesh, _ = self._mesh_and_robin()
        right = boundary_edges(mesh,
                               predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        f = jnp.ones(mesh.n_nodes)
        r_nodal = jnp.linspace(-1.0, 1.0, mesh.n_nodes)

        def loss(method):
            def fn(alpha):
                rb = robin_edges(mesh, right, alpha, r_nodal)
                u = solve_poisson(mesh, 1.0, f, method=method, robin=rb)
                return jnp.sum(u ** 2)
            return fn

        ga_s = jax.grad(loss("stencil"))(jnp.asarray(1.7))
        ga_d = jax.grad(loss("dense"))(jnp.asarray(1.7))
        np.testing.assert_allclose(float(ga_s), float(ga_d), rtol=1e-6)

    def test_pure_robin_no_dirichlet(self):
        """Robin everywhere, zero Dirichlet nodes — α pins the solution
        (the natural path must not require a Dirichlet set)."""
        full = FEMesh.rectangle(nx=5, ny=5)
        mesh = dataclasses.replace(
            full, bc_mask=jnp.zeros(full.n_nodes, full.dtype))
        edges = boundary_edges(mesh)
        rb = robin_edges(mesh, edges, 1.0, jnp.zeros(mesh.n_nodes))
        f = jnp.ones(mesh.n_nodes)
        u_st = solve_poisson(mesh, 1.0, f, method="stencil", robin=rb)
        u_de = solve_poisson(mesh, 1.0, f, method="dense", robin=rb)
        np.testing.assert_allclose(np.asarray(u_st), np.asarray(u_de),
                                   atol=1e-9)

    def test_unfoldable_robin_falls_back(self):
        """A Robin coupling between non-adjacent nodes can't fold into
        the stencil: auto falls back to the generic path (same answer),
        method='stencil' raises."""
        mesh = left_dirichlet_rectangle(5, 5)
        # couple node 0's row to the far corner — not grid-adjacent
        far = mesh.n_nodes - 1
        free = int(np.nonzero(np.asarray(mesh.bc_mask) < 0.5)[0][0])
        rb = RobinBC(rows=jnp.asarray([free, far], jnp.int32),
                     cols=jnp.asarray([far, free], jnp.int32),
                     vals=jnp.asarray([0.5, 0.5]),
                     load=jnp.zeros(mesh.n_nodes))
        f = jnp.ones(mesh.n_nodes)
        u_auto = solve_poisson(mesh, 1.0, f, robin=rb)
        u_dense = solve_poisson(mesh, 1.0, f, method="dense", robin=rb)
        np.testing.assert_allclose(np.asarray(u_auto),
                                   np.asarray(u_dense), atol=1e-9)
        with pytest.raises(ValueError, match="non-adjacent"):
            solve_poisson(mesh, 1.0, f, method="stencil", robin=rb)


class TestNaturalPallasRoute:
    """Batched fixed-trip natural-BC solves keep the structured stencil
    route (per-scenario PCG under vmap) for flux-BC users."""

    def test_batched_fixed_trip_neumann_matches_dense(self):
        mesh = left_dirichlet_rectangle(8, 8)
        B = 4
        rng = np.random.default_rng(7)
        right = boundary_edges(mesh,
                               predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        qB = jnp.asarray(rng.normal(size=(B, mesh.n_nodes)))
        nmB = edge_flux_load(mesh, right, qB)
        fB = jnp.asarray(rng.normal(size=(B, mesh.n_nodes)))
        kB = jnp.asarray(rng.uniform(0.8, 1.5, (B, mesh.n_elements)))
        uB = solve_poisson_batched(mesh, kB, fB, neumann=nmB,
                                   cg_tol=0.0, cg_maxiter=200)
        for i in range(B):
            u1 = solve_poisson(mesh, kB[i], fB[i], method="dense",
                               neumann=nmB[i])
            np.testing.assert_allclose(np.asarray(uB[i]),
                                       np.asarray(u1), atol=1e-5)

    def test_batched_fixed_trip_robin_matches_dense(self):
        mesh = left_dirichlet_rectangle(6, 6)
        B = 3
        right = boundary_edges(mesh,
                               predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        r_nodal = jnp.linspace(-1, 1, mesh.n_nodes)
        rb = robin_edges(mesh, right, 2.0, r_nodal)
        fB = jnp.ones((B, mesh.n_nodes))
        uB = solve_poisson_batched(mesh, 1.0, fB, robin=rb,
                                   cg_tol=0.0, cg_maxiter=200)
        u1 = solve_poisson(mesh, 1.0, fB[0], method="dense", robin=rb)
        np.testing.assert_allclose(np.asarray(uB[0]), np.asarray(u1),
                                   atol=1e-5)

    def test_gradients_through_batched_route(self):
        mesh = left_dirichlet_rectangle(6, 5)
        B = 2
        rng = np.random.default_rng(8)
        right = boundary_edges(mesh,
                               predicate=lambda p: abs(p[0] - 1.0) < 1e-12)
        nmB = edge_flux_load(mesh, right,
                             jnp.asarray(rng.normal(
                                 size=(B, mesh.n_nodes))))
        fB = jnp.ones((B, mesh.n_nodes))
        kB = jnp.asarray(rng.uniform(0.8, 1.5, (B, mesh.n_elements)))

        def loss_fast(k):
            u = solve_poisson_batched(mesh, k, fB, neumann=nmB,
                                      cg_tol=0.0, cg_maxiter=200)
            return jnp.sum(u ** 2)

        def loss_dense(k):
            u = jax.vmap(lambda kk, ff, nn: solve_poisson(
                mesh, kk, ff, method="dense", neumann=nn))(k, fB, nmB)
            return jnp.sum(u ** 2)

        gf = jax.grad(loss_fast)(kB)
        gd = jax.grad(loss_dense)(kB)
        np.testing.assert_allclose(np.asarray(gf), np.asarray(gd),
                                   rtol=1e-4, atol=1e-7)


class TestGeneralDirichletMask:
    def test_interior_pin_structured_matches_dense(self):
        """A mesh with an extra interior Dirichlet node (grid metadata
        kept) routes through the generalized-mask solver and matches
        dense elimination."""
        full = FEMesh.rectangle(nx=6, ny=6)
        pin = full.n_nodes // 2
        bc_mask = full.bc_mask.at[pin].set(1.0)
        bc_values = full.bc_values.at[pin].set(0.7)
        mesh = dataclasses.replace(full, bc_mask=bc_mask,
                                   bc_values=bc_values)
        f = jnp.ones(mesh.n_nodes)
        u_st = solve_poisson(mesh, 1.0, f, method="stencil")
        u_de = solve_poisson(mesh, 1.0, f, method="dense")
        np.testing.assert_allclose(np.asarray(u_st), np.asarray(u_de),
                                   atol=1e-9)
        assert abs(float(u_st[pin]) - 0.7) < 1e-12

    def test_batched_fixed_trip_respects_custom_mask(self):
        """A custom-mask mesh (grid kept) must solve with ITS mask on the
        batched fixed-trip route, not the factory one — regression for
        the silent-wrong-answer hazard."""
        full = FEMesh.rectangle(nx=8, ny=8, dtype=jnp.float32)
        pin = full.n_nodes // 2
        mesh = dataclasses.replace(
            full, bc_mask=full.bc_mask.at[pin].set(1.0),
            bc_values=full.bc_values.at[pin].set(0.3))
        B = 4
        fB = jnp.ones((B, mesh.n_nodes), jnp.float32)
        uB = solve_poisson_batched(mesh, 1.0, fB, cg_tol=0.0,
                                   cg_maxiter=200)
        u1 = solve_poisson(mesh, 1.0, fB[0], method="dense")
        np.testing.assert_allclose(np.asarray(uB[0]), np.asarray(u1),
                                   atol=1e-4)
        assert abs(float(uB[0, pin]) - 0.3) < 1e-6

    def test_fit_kappa_custom_mask_takes_generic_route(self):
        from difffe_tpu.inverse import fit_kappa
        full = FEMesh.rectangle(nx=4, ny=4, dtype=jnp.float32)
        pin = full.n_nodes // 2
        mesh = dataclasses.replace(
            full, bc_mask=full.bc_mask.at[pin].set(1.0))
        B = 2
        fB = jnp.ones((B, mesh.n_nodes), jnp.float32)
        uB = solve_poisson_batched(mesh, 1.0, fB)
        _, info = fit_kappa(mesh, fB, uB, steps=5)
        assert info["path"] == "generic_adam"

    def test_factory_mask_unchanged_path_still_exact(self):
        """The factory-mask mesh still takes the specialized solver (no
        behavior change)."""
        mesh = FEMesh.rectangle(nx=8, ny=8)
        f = jnp.ones(mesh.n_nodes)
        u_auto = solve_poisson(mesh, 1.0, f)
        u_dense = solve_poisson(mesh, 1.0, f, method="dense")
        np.testing.assert_allclose(np.asarray(u_auto),
                                   np.asarray(u_dense), atol=1e-10)
