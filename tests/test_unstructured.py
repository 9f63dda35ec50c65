"""ELL gather-only unstructured operator (ops/unstructured.py) vs the
element-centric gather/scatter path — exact operator parity, solve
parity, and gradient parity, on a genuinely irregular triangulation
(perturbed interior nodes), batched and unbatched."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from difffe_tpu.mesh import FEMesh
from difffe_tpu.ops.assembly import assemble_load, stiffness_apply
from difffe_tpu.ops.cg import solve_poisson_cg, stiffness_diag
from difffe_tpu.ops.unstructured import (ELL, build_ell, ell_apply,
                                         ell_diag, solve_poisson_cg_ell)


def _irregular_mesh(n=8, seed=0):
    """Rectangle triangulation with interior nodes randomly perturbed —
    arbitrary connectivity + arbitrary geometry (no structure to exploit)."""
    mesh = FEMesh.rectangle(nx=n, ny=n)
    nodes = np.asarray(mesh.nodes).copy()
    rng = np.random.RandomState(seed)
    interior = np.asarray(mesh.bc_mask) < 0.5
    h = 1.0 / n
    nodes[interior] += rng.uniform(-0.3 * h, 0.3 * h,
                                   nodes[interior].shape)
    return dataclasses.replace(mesh, nodes=jnp.asarray(nodes,
                                                       mesh.dtype))


class TestELLOperator:
    @pytest.mark.parametrize("make_mesh", [
        lambda: FEMesh.rectangle(nx=6, ny=5),
        _irregular_mesh,
    ])
    def test_apply_matches_element_path(self, make_mesh):
        mesh = make_mesh()
        ell = build_ell(mesh)
        ne = mesh.n_elements
        kappa = 1.0 + jax.random.uniform(jax.random.PRNGKey(1), (ne,),
                                         mesh.dtype)
        u = jax.random.normal(jax.random.PRNGKey(2), (3, mesh.n_nodes),
                              mesh.dtype)
        got = ell_apply(mesh, ell, kappa, u)
        want = stiffness_apply(mesh, kappa, u)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)

    def test_diag_matches(self):
        mesh = _irregular_mesh()
        ell = build_ell(mesh)
        kappa = 1.0 + jax.random.uniform(jax.random.PRNGKey(3),
                                         (mesh.n_elements,), mesh.dtype)
        np.testing.assert_allclose(
            np.asarray(ell_diag(mesh, ell, kappa)),
            np.asarray(stiffness_diag(mesh, kappa)),
            rtol=1e-12, atol=1e-12)

    def test_scalar_and_per_node_kappa(self):
        mesh = _irregular_mesh()
        ell = build_ell(mesh)
        u = jax.random.normal(jax.random.PRNGKey(4), (mesh.n_nodes,),
                              mesh.dtype)
        for kappa in (2.0, 1.0 + jax.random.uniform(
                jax.random.PRNGKey(5), (mesh.n_nodes,), mesh.dtype)):
            np.testing.assert_allclose(
                np.asarray(ell_apply(mesh, ell, kappa, u)),
                np.asarray(stiffness_apply(mesh, kappa, u)),
                rtol=1e-12, atol=1e-12)


class TestELLSolve:
    def test_solve_matches_cg(self):
        mesh = _irregular_mesh()
        ell = build_ell(mesh)
        kappa = 1.0 + jax.random.uniform(jax.random.PRNGKey(6),
                                         (mesh.n_elements,), mesh.dtype)
        F = assemble_load(mesh, jnp.ones(mesh.n_nodes, mesh.dtype))
        u_ell = solve_poisson_cg_ell(mesh, ell, kappa, F, 0.0, 200)
        u_ref = solve_poisson_cg(mesh, kappa, F, 0.0, 200)
        np.testing.assert_allclose(np.asarray(u_ell), np.asarray(u_ref),
                                   rtol=1e-10, atol=1e-12)

    def test_batched_solve_vmap(self):
        mesh = FEMesh.rectangle(nx=6, ny=6)
        ell = build_ell(mesh)
        B = 4
        kappa = 1.0 + jax.random.uniform(jax.random.PRNGKey(7),
                                         (B, mesh.n_elements), mesh.dtype)
        F = jnp.broadcast_to(
            assemble_load(mesh, jnp.ones(mesh.n_nodes, mesh.dtype)),
            (B, mesh.n_nodes))
        sol = jax.vmap(lambda k, f: solve_poisson_cg_ell(
            mesh, ell, k, f, 0.0, 150))(kappa, F)
        ref = jax.vmap(lambda k, f: solve_poisson_cg(
            mesh, k, f, 0.0, 150))(kappa, F)
        np.testing.assert_allclose(np.asarray(sol), np.asarray(ref),
                                   rtol=1e-10, atol=1e-12)

    def test_gradients_match_cg_path(self):
        mesh = _irregular_mesh(n=6)
        ell = build_ell(mesh)
        kappa = 1.0 + jax.random.uniform(jax.random.PRNGKey(8),
                                         (mesh.n_elements,), mesh.dtype)
        F = assemble_load(mesh, jnp.ones(mesh.n_nodes, mesh.dtype))
        u_tgt = solve_poisson_cg(mesh, kappa * 1.3, F, 0.0, 200)

        def loss_ell(k, f):
            u = solve_poisson_cg_ell(mesh, ell, k, f, 0.0, 200)
            return jnp.mean((u - u_tgt) ** 2)

        def loss_ref(k, f):
            u = solve_poisson_cg(mesh, k, f, 0.0, 200)
            return jnp.mean((u - u_tgt) ** 2)

        gk_e, gF_e = jax.grad(loss_ell, argnums=(0, 1))(kappa, F)
        gk_r, gF_r = jax.grad(loss_ref, argnums=(0, 1))(kappa, F)
        np.testing.assert_allclose(np.asarray(gk_e), np.asarray(gk_r),
                                   rtol=1e-8, atol=1e-14)
        np.testing.assert_allclose(np.asarray(gF_e), np.asarray(gF_r),
                                   rtol=1e-8, atol=1e-14)

    def test_jit_under_scan_sgd(self):
        """The production shape: a jitted SGD scan over ELL grad steps."""
        mesh = FEMesh.rectangle(nx=6, ny=6)
        ell = build_ell(mesh)
        B = 3
        k_true = 1.0 + jax.random.uniform(jax.random.PRNGKey(9),
                                          (B, mesh.n_elements), mesh.dtype)
        F = jnp.broadcast_to(
            assemble_load(mesh, jnp.ones(mesh.n_nodes, mesh.dtype)),
            (B, mesh.n_nodes))
        solveB = jax.vmap(lambda k, f: solve_poisson_cg_ell(
            mesh, ell, k, f, 0.0, 100))
        u_data = solveB(k_true, F)

        def loss(k):
            return jnp.mean((solveB(k, F) - u_data) ** 2)

        g = jax.grad(loss)

        @jax.jit
        def run(k0):
            def step(k, _):
                return k - 50.0 * g(k), 0.0
            k, _ = jax.lax.scan(step, k0, None, length=5)
            return k, loss(k)

        k0 = jnp.ones((B, mesh.n_elements), mesh.dtype)
        k5, l5 = run(k0)
        assert bool(jnp.isfinite(k5).all())
        assert float(l5) < float(loss(k0))


class TestELLBatchMinor:
    """solve_poisson_cg_ell_batched (batch-minor layout) ≡ vmapped
    solve_poisson_cg_ell — forward, κ/F gradients, scalar-batch κ."""

    def _setup(self, B=5):
        from difffe_tpu.ops.unstructured import solve_poisson_cg_ell_batched
        mesh = FEMesh.rectangle(8, 8, dtype=jnp.float32)
        ell = build_ell(mesh)
        key = jax.random.PRNGKey(0)
        kB = 1.0 + jax.random.uniform(key, (B, mesh.n_elements),
                                      jnp.float32)
        f = (jnp.sin(jnp.pi * mesh.nodes[:, 0])
             * jnp.sin(jnp.pi * mesh.nodes[:, 1]) * 19.7)
        FB = jnp.broadcast_to(assemble_load(mesh, f), (B, mesh.n_nodes))
        return mesh, ell, kB, FB, solve_poisson_cg_ell_batched

    def test_forward_matches_vmap(self):
        from difffe_tpu.ops.unstructured import solve_poisson_cg_ell
        mesh, ell, kB, FB, solveB = self._setup()
        u_ref = jax.vmap(lambda k, F: solve_poisson_cg_ell(
            mesh, ell, k, F, 0.0, 100))(kB, FB)
        u_bm = solveB(mesh, ell, kB, FB, 0.0, 100)
        np.testing.assert_allclose(np.asarray(u_bm), np.asarray(u_ref),
                                   atol=1e-6)

    def test_gradients_match_vmap(self):
        from difffe_tpu.ops.unstructured import solve_poisson_cg_ell
        mesh, ell, kB, FB, solveB = self._setup()
        ud = jax.vmap(lambda k, F: solve_poisson_cg_ell(
            mesh, ell, k, F, 0.0, 100))(kB, FB) + 0.01

        def loss_ref(k, F):
            u = jax.vmap(lambda kk, FF: solve_poisson_cg_ell(
                mesh, ell, kk, FF, 0.0, 100))(k, F)
            return jnp.mean((u - ud) ** 2)

        def loss_bm(k, F):
            return jnp.mean((solveB(mesh, ell, k, F, 0.0, 100) - ud) ** 2)

        g_ref = jax.grad(loss_ref, argnums=(0, 1))(kB, FB)
        g_bm = jax.grad(loss_bm, argnums=(0, 1))(kB, FB)
        np.testing.assert_allclose(np.asarray(g_bm[0]),
                                   np.asarray(g_ref[0]), atol=1e-9)
        np.testing.assert_allclose(np.asarray(g_bm[1]),
                                   np.asarray(g_ref[1]), atol=1e-9)

    def test_scalar_batch_kappa(self):
        from difffe_tpu.ops.unstructured import solve_poisson_cg_ell
        mesh, ell, _, FB, solveB = self._setup()
        B = FB.shape[0]
        ks = 1.0 + 0.1 * jnp.arange(B, dtype=jnp.float32)
        u_bm = solveB(mesh, ell, ks, FB, 0.0, 100)
        u_ref = jax.vmap(lambda k, F: solve_poisson_cg_ell(
            mesh, ell, jnp.full((mesh.n_elements,), k), F, 0.0, 100))(
                ks, FB)
        np.testing.assert_allclose(np.asarray(u_bm), np.asarray(u_ref),
                                   atol=1e-6)

    def test_bad_F_shape_raises(self):
        mesh, ell, kB, FB, solveB = self._setup()
        with pytest.raises(ValueError, match="B, n_nodes"):
            solveB(mesh, ell, kB, FB[0], 0.0, 10)


class TestKappaCotangent:
    """The κ-gradient's element contraction in difference form."""

    def test_equals_direct_contraction(self):
        from difffe_tpu.ops.assembly import local_stiffness
        from difffe_tpu.ops.unstructured import _kappa_cotangent
        mesh = _irregular_mesh(5, seed=2)
        rng = np.random.default_rng(0)
        lam = jnp.asarray(rng.normal(size=(mesh.n_nodes, 3)))
        u = jnp.asarray(rng.normal(size=(mesh.n_nodes, 3)))
        G = local_stiffness(mesh, jnp.ones(mesh.n_elements))
        el = mesh.elements
        direct = -jnp.einsum("epb,epq,eqb->eb", lam[el], G, u[el])
        np.testing.assert_allclose(np.asarray(_kappa_cotangent(mesh, lam, u)),
                                   np.asarray(direct), atol=1e-12)

    @pytest.mark.parametrize("batched", [False, True])
    def test_float32_gradient_vs_f64_reference(self, batched):
        """A float32 32×32 perturbed mesh: the adjoint κ-gradient stays
        within 3e-5 (relative to its max) of a scipy f64 solve.  The
        contraction −λᵀ(G u) read 1.2e-4 here."""
        import chip_smoke as cs
        from difffe_tpu.cli import invert_workload
        from difffe_tpu.ops.unstructured import solve_poisson_cg_ell_batched
        mesh, fB, u_data, k_true = invert_workload(2, 32, 2,
                                                   unstructured=True)
        kp = 0.5 * (1.0 + k_true)
        if batched:
            _, g_err, _ = cs.unstructured_parity(mesh, kp, fB, u_data, 512)
        else:
            ell = build_ell(mesh)
            FB = assemble_load(mesh, fB)

            def loss(k):
                u = jax.vmap(lambda kk, F: solve_poisson_cg_ell(
                    mesh, ell, kk, F, 0.0, 512))(k, FB)
                return 0.5 * jnp.sum((u - u_data) ** 2)

            g = jax.jit(jax.grad(loss))(kp)
            refs = [cs.ref_solve_grad(mesh.nodes, mesh.elements,
                                      mesh.bc_mask, mesh.bc_values, kp[b],
                                      fB[b], u_data[b]) for b in range(2)]
            g_err = cs.rel_err(g, [r[1] for r in refs])
        assert g_err < 3e-5, g_err
