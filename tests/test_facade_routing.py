"""The public facade routes structured meshes onto the stencil fast paths.

VERDICT-r3 item 1: ``solve_poisson(method="auto")`` on a
``FEMesh.rectangle``/``FEMesh.box`` mesh must take the closed-form stencil
route (ops/stencil.py / ops/stencil3d.py) — not generic gather CG — and
match the generic paths numerically, including gradients; ``fit_kappa`` is
the one inversion-loop API encoding the measured iters/warm/layout policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from difffe_tpu import (FEMesh, fit_kappa, solve_poisson,
                        solve_poisson_batched)
from difffe_tpu.solver import _resolve_method


def _f2(mesh):
    x, y = mesh.nodes[:, 0], mesh.nodes[:, 1]
    return 2 * jnp.pi ** 2 * jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)


class TestResolution:
    def test_rectangle_routes_to_stencil(self):
        m = FEMesh.rectangle(8, 8)
        assert m.grid is not None
        assert _resolve_method(m, "auto", 1.0) == "stencil"

    def test_box_routes_to_stencil(self):
        m = FEMesh.box(4, 4, 4)
        assert m.grid is not None
        assert _resolve_method(m, "auto", 1.0) == "stencil"

    def test_line_still_tridiag(self):
        assert _resolve_method(FEMesh.line(10), "auto", 1.0) == "tridiag"

    def test_with_dirichlet_drops_grid(self):
        m = FEMesh.rectangle(8, 8).with_dirichlet([40], [0.5])
        assert m.grid is None
        assert _resolve_method(m, "auto", 1.0) != "stencil"

    def test_tensor_kappa_falls_back(self):
        m = FEMesh.rectangle(8, 8)
        A = jnp.array([[2.0, 0.3], [0.3, 1.0]])
        assert _resolve_method(m, "auto", A) != "stencil"

    def test_neumann_robin_fall_back(self):
        m = FEMesh.rectangle(8, 8)
        assert _resolve_method(m, "auto", 1.0,
                               structured_ok=False) != "stencil"

    def test_p2_rectangle_not_structured(self):
        m = FEMesh.rectangle_p2(4, 4)
        assert m.grid is None

    def test_explicit_stencil_on_general_mesh_raises(self):
        m = FEMesh.rectangle(4, 4).with_dirichlet([6], [0.1])
        with pytest.raises(ValueError, match="structured-grid metadata"):
            solve_poisson(m, 1.0, jnp.ones(m.n_nodes), method="stencil")

    def test_astype_keeps_grid(self):
        m = FEMesh.rectangle(4, 4).astype(jnp.float32)
        assert m.grid is not None


class TestNumericalParity:
    @pytest.mark.parametrize("kappa_kind", ["scalar", "element", "node"])
    def test_2d_auto_matches_dense(self, kappa_kind):
        m = FEMesh.rectangle(8, 8)
        key = jax.random.PRNGKey(0)
        kappa = {"scalar": 1.3,
                 "element": 1.0 + 0.5 * jax.random.uniform(
                     key, (m.n_elements,)),
                 "node": 1.0 + 0.5 * jax.random.uniform(
                     key, (m.n_nodes,))}[kappa_kind]
        f = _f2(m)
        u_auto = solve_poisson(m, kappa, f)
        u_dense = solve_poisson(m, kappa, f, method="dense")
        np.testing.assert_allclose(np.asarray(u_auto), np.asarray(u_dense),
                                   atol=1e-9)

    def test_2d_nonzero_bc(self):
        m = FEMesh.rectangle(6, 6, bc_value=0.7)
        f = _f2(m)
        np.testing.assert_allclose(
            np.asarray(solve_poisson(m, 1.0, f)),
            np.asarray(solve_poisson(m, 1.0, f, method="dense")), atol=1e-9)

    def test_2d_bc_values_override(self):
        m = FEMesh.rectangle(6, 6)
        f = _f2(m)
        g = 0.2 * m.bc_mask
        np.testing.assert_allclose(
            np.asarray(solve_poisson(m, 1.0, f, bc_values=g)),
            np.asarray(solve_poisson(m, 1.0, f, bc_values=g,
                                     method="dense")), atol=1e-9)

    def test_3d_auto_matches_dense(self):
        m = FEMesh.box(3, 3, 3)
        key = jax.random.PRNGKey(1)
        ke = 1.0 + 0.5 * jax.random.uniform(key, (m.n_elements,))
        f = jnp.ones(m.n_nodes)
        np.testing.assert_allclose(
            np.asarray(solve_poisson(m, ke, f)),
            np.asarray(solve_poisson(m, ke, f, method="dense")), atol=1e-9)

    def test_gradient_parity_scalar(self):
        m = FEMesh.rectangle(6, 6)
        f = _f2(m)
        loss_a = lambda k: jnp.sum(solve_poisson(m, k, f) ** 2)
        loss_d = lambda k: jnp.sum(
            solve_poisson(m, k, f, method="dense") ** 2)
        np.testing.assert_allclose(float(jax.grad(loss_a)(1.3)),
                                   float(jax.grad(loss_d)(1.3)), rtol=1e-6)

    def test_gradient_parity_field_and_f(self):
        m = FEMesh.box(3, 3, 3)
        key = jax.random.PRNGKey(2)
        ke = 1.0 + 0.5 * jax.random.uniform(key, (m.n_elements,))
        f = 1.0 + jax.random.uniform(key, (m.n_nodes,))

        def loss(method):
            return lambda ke, f: jnp.sum(
                solve_poisson(m, ke, f, method=method) ** 2)

        ga = jax.grad(loss("auto"), argnums=(0, 1))(ke, f)
        gd = jax.grad(loss("dense"), argnums=(0, 1))(ke, f)
        np.testing.assert_allclose(np.asarray(ga[0]), np.asarray(gd[0]),
                                   atol=1e-8)
        np.testing.assert_allclose(np.asarray(ga[1]), np.asarray(gd[1]),
                                   atol=1e-8)

    def test_batched_2d_matches_loop(self):
        m = FEMesh.rectangle(6, 6)
        B = 3
        kB = 1.0 + 0.2 * jnp.arange(B, dtype=m.dtype)
        fB = jnp.broadcast_to(_f2(m), (B, m.n_nodes))
        uB = solve_poisson_batched(m, kB, fB, kappa_batched=True)
        for b in range(B):
            np.testing.assert_allclose(
                np.asarray(uB[b]), np.asarray(solve_poisson(m, kB[b], fB[b])),
                atol=1e-9)

    def test_batched_3d_batchminor_branch(self):
        # B ≥ 128 triggers the batch-minor layout; equality vs the
        # per-scenario route
        m = FEMesh.box(3, 3, 3)
        B = 130
        key = jax.random.PRNGKey(3)
        kB = 1.0 + 0.5 * jax.random.uniform(key, (B, m.n_elements))
        fB = jnp.broadcast_to(jnp.ones(m.n_nodes), (B, m.n_nodes))
        uB = solve_poisson_batched(m, kB, fB)
        for b in (0, 64, 129):
            np.testing.assert_allclose(
                np.asarray(uB[b]),
                np.asarray(solve_poisson(m, kB[b], fB[b])), atol=1e-8)

    def test_neumann_falls_back_and_matches(self):
        # a Neumann load must NOT silently vanish down the stencil route
        m = FEMesh.rectangle(6, 6)
        f = _f2(m)
        nm = jnp.zeros(m.n_nodes).at[10].set(0.3)
        u = solve_poisson(m, 1.0, f, neumann=nm)
        u_dense = solve_poisson(m, 1.0, f, neumann=nm, method="dense")
        np.testing.assert_allclose(np.asarray(u), np.asarray(u_dense),
                                   atol=1e-9)


class TestSecondOrder:
    """Newton/Hessian polish must survive the stencil routing: the IFT
    adjoints go through the recursive ``apply_inv`` custom_vjp primitives,
    so reverse-over-reverse composes (regression: the raw-pcg bwd made
    jax.grad(jax.grad(...)) raise on while_loop)."""

    @pytest.mark.parametrize("factory", ["rectangle", "box"])
    def test_hessian_through_auto(self, factory):
        m = FEMesh.rectangle(5, 5) if factory == "rectangle" \
            else FEMesh.box(3, 3, 3)
        f = jnp.ones(m.n_nodes)
        u_data = solve_poisson(m, 2.0, f)

        def loss(log_k):
            u = solve_poisson(m, jnp.exp(log_k), f)
            return jnp.mean((u - u_data) ** 2)

        assert _resolve_method(m, "auto", 1.0) == "stencil"
        h = jax.grad(jax.grad(loss))
        hd = jax.grad(jax.grad(
            lambda lk: jnp.mean((solve_poisson(
                m, jnp.exp(lk), f, method="dense") - u_data) ** 2)))
        np.testing.assert_allclose(float(h(0.3)), float(hd(0.3)),
                                   rtol=1e-5)


class TestFitKappa:
    def _workload(self, mesh, B, key):
        f = jnp.prod(jnp.sin(jnp.pi * mesh.nodes), axis=1) * 10.0
        fB = jnp.broadcast_to(f, (B, mesh.n_nodes))
        k_true = 1.2 + 0.6 * jax.random.uniform(key, (B, mesh.n_elements),
                                                mesh.dtype)
        u_data = solve_poisson_batched(mesh, k_true, fB,
                                       cg_tol=0.0, cg_maxiter=200)
        return fB, k_true, u_data

    def test_2d_routes_to_kernel_and_descends(self):
        m = FEMesh.rectangle(8, 8, dtype=jnp.float32)
        fB, k_true, u_data = self._workload(m, 4, jax.random.PRNGKey(5))
        k, info = fit_kappa(m, fB, u_data, steps=40)
        assert info["path"] == "stencil2d_xla"
        assert info["iters"] == 32 and info["warm"] is True
        assert k.shape == (4, m.n_elements)
        assert info["eval_loss"] < 0.5 * float(info["loss_history"][0])

    def test_3d_routes_batchminor_and_descends(self):
        m = FEMesh.box(4, 4, 4, dtype=jnp.float32)
        fB, k_true, u_data = self._workload(m, 4, jax.random.PRNGKey(6))
        k, info = fit_kappa(m, fB, u_data, steps=40, lr=50.0)
        assert info["path"] == "stencil3d_batchminor"
        # round-4 control: 32 is the κ-error-safe production default
        # (probe_3d_control.py — 16 caps accuracy at deep convergence)
        assert info["iters"] == 32 and info["warm"] is False
        assert info["eval_loss"] < float(info["loss_history"][0])

    def test_3d_default_lr_scales_with_batch(self):
        """The 3D loss means over the batch, so the κ-gradient magnitude
        is ∝1/B; the default lr folds that in (lr = 100·B/256,
        VERDICT-r4 item 7).  Replicating the SAME scenarios 8× must then
        reproduce the B=4 trajectory exactly — under the old fixed
        lr=100 default, the B=4 run took 8× the step and diverged from
        it."""
        m = FEMesh.box(4, 4, 4, dtype=jnp.float32)
        B = 4
        fB, k_true, u_data = self._workload(m, B, jax.random.PRNGKey(11))
        k4, info4 = fit_kappa(m, fB, u_data, steps=60)
        rep = (8, 1)
        k32, info32 = fit_kappa(m, jnp.tile(fB, rep),
                                jnp.tile(u_data, rep), steps=60)
        # strict descent with the default lr at both batch sizes
        assert info4["eval_loss"] < float(info4["loss_history"][0])
        assert info32["eval_loss"] < float(info32["loss_history"][0])
        # B-invariant effective step → identical per-scenario trajectory
        np.testing.assert_allclose(np.asarray(k32[:B]), np.asarray(k4),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(info32["eval_loss"],
                                   info4["eval_loss"], rtol=1e-3)

    def test_generic_mesh_falls_back(self):
        m = FEMesh.rectangle(4, 4).with_dirichlet([6], [0.0])
        fB, k_true, u_data = self._workload(m, 2, jax.random.PRNGKey(7))
        k, info = fit_kappa(m, fB, u_data, steps=20)
        assert info["path"] == "generic_adam"
        assert k.shape == (2, m.n_elements)

    def test_2d_recovers_kappa(self):
        # longer run actually recovers the field (smoke-scale accuracy gate)
        m = FEMesh.rectangle(6, 6, dtype=jnp.float32)
        B = 2
        fB, k_true, u_data = self._workload(m, B, jax.random.PRNGKey(8))
        k, info = fit_kappa(m, fB, u_data, steps=300)
        assert info["eval_loss"] < 1e-2 * float(info["loss_history"][0])


class TestBatchedFixedTripPallasRoute:
    def test_2d_fixed_trip_matches_vmap_stencil(self):
        m = FEMesh.rectangle(8, 8, dtype=jnp.float32)
        B = 5
        key = jax.random.PRNGKey(0)
        kB = (1.0 + 0.5 * jax.random.uniform(
            key, (B, m.n_elements))).astype(jnp.float32)
        fB = jnp.broadcast_to(_f2(m), (B, m.n_nodes)).astype(jnp.float32)
        # fixed-trip batched → per-scenario PCG under vmap
        uB = solve_poisson_batched(m, kB, fB, cg_tol=0.0, cg_maxiter=120)
        for b in (0, 4):
            u1 = solve_poisson(m, kB[b], fB[b], cg_tol=0.0,
                               cg_maxiter=120)
            np.testing.assert_allclose(np.asarray(uB[b]), np.asarray(u1),
                                       atol=1e-4)

    def test_gradients_flow_through_pallas_route(self):
        m = FEMesh.rectangle(6, 6, dtype=jnp.float32)
        B = 3
        kB = (1.0 + 0.1 * jnp.arange(B, dtype=jnp.float32))
        fB = jnp.broadcast_to(_f2(m), (B, m.n_nodes)).astype(jnp.float32)

        def loss(k):
            u = solve_poisson_batched(m, k, fB, kappa_batched=True,
                                      cg_tol=0.0, cg_maxiter=100)
            return jnp.sum(u ** 2)

        def loss_ref(k):
            u = solve_poisson_batched(m, k, fB, kappa_batched=True,
                                      method="dense")
            return jnp.sum(u ** 2)

        g = jax.grad(loss)(kB)
        g_ref = jax.grad(loss_ref)(kB)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                                   rtol=1e-3)


class TestGenericEllRoute:
    def test_fit_kappa_large_batch_takes_ell(self):
        # with_dirichlet drops the grid → generic; B ≥ 128 → ELL
        m = FEMesh.rectangle(4, 4, dtype=jnp.float32).with_dirichlet(
            [6], [0.0])
        B = 128
        f = jnp.broadcast_to(
            10 * jnp.prod(jnp.sin(jnp.pi * m.nodes), axis=1),
            (B, m.n_nodes)).astype(jnp.float32)
        kt = 1.2 + 0.6 * jax.random.uniform(jax.random.PRNGKey(0),
                                            (B, m.n_elements), jnp.float32)
        ud = solve_poisson_batched(m, kt, f, cg_tol=0.0, cg_maxiter=100)
        k, info = fit_kappa(m, f, ud, steps=30)
        assert info["path"] == "generic_ell_batchminor"
        assert info["eval_loss"] < float(info["loss_history"][0])


class TestSecondOrderBatched3D:
    def test_hessian_through_batchminor_route(self):
        # B >= 128 forces the batch-minor custom_vjp; its adjoint rides
        # the recursive _apply_inv_bm primitive, so grad-of-grad works
        m = FEMesh.box(2, 2, 2)
        B = 128
        fB = jnp.broadcast_to(jnp.ones(m.n_nodes), (B, m.n_nodes))
        u_data = solve_poisson_batched(
            m, jnp.full((B,), 2.0), fB, kappa_batched=True)

        def loss(log_k):
            u = solve_poisson_batched(m, jnp.exp(log_k) * jnp.ones(B),
                                      fB, kappa_batched=True)
            return jnp.mean((u - u_data) ** 2)

        h = float(jax.grad(jax.grad(loss))(0.3))
        # reference Hessian via the dense path on one scenario
        def loss1(log_k):
            u = solve_poisson(m, jnp.exp(log_k), fB[0], method="dense")
            return jnp.mean((u - u_data[0]) ** 2)

        h_ref = float(jax.grad(jax.grad(loss1))(0.3))
        np.testing.assert_allclose(h, h_ref, rtol=1e-4)
