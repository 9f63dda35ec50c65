"""Backend dispatch, removed options, the compile-cache rule, and the
chip smoke script's phases at tiny sizes on the CPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from difffe_tpu.inverse import CHAIN_MAX_ELEMENTS, fit_kappa, fit_route
from difffe_tpu.mesh import FEMesh
from difffe_tpu.solver import solve_poisson, solve_poisson_batched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestFitRoute:
    @pytest.mark.parametrize("backend,dim,route", [
        ("gpu", 1, "cf_chain_triton"),
        ("cpu", 1, "cf_xla"),
        ("gpu", 2, "stencil2d_xla"),
        ("cpu", 2, "stencil2d_xla"),
        ("gpu", 3, "stencil3d_batchminor"),
        ("cpu", 3, "stencil3d_batchminor"),
    ])
    def test_route_by_backend_and_dim(self, backend, dim, route):
        assert fit_route(dim, backend) == route

    @pytest.mark.parametrize("backend", ["gpu", "cpu"])
    def test_per_scenario_forcing_never_takes_the_kernel(self, backend):
        assert fit_route(1, backend, shared_forcing=False) == "cf_xla"

    @pytest.mark.parametrize("ne,route", [
        (30, "cf_chain_triton"), (CHAIN_MAX_ELEMENTS, "cf_chain_triton"),
        (CHAIN_MAX_ELEMENTS + 1, "cf_xla"), (1 << 20, "cf_xla")])
    def test_long_chains_leave_the_kernel_on_gpu(self, ne, route):
        assert fit_route(1, "gpu", n_elements=ne) == route
        assert fit_route(1, "cpu", n_elements=ne) == "cf_xla"

    def test_fit_kappa_passes_the_chain_length(self, monkeypatch):
        from difffe_tpu import inverse
        seen = []
        real = inverse.fit_route
        monkeypatch.setattr(inverse, "fit_route", lambda *a, **k: (
            seen.append(a), real(*a, **k))[1])
        mesh = FEMesh.line(9, dtype=jnp.float32)
        f = jnp.ones((2, mesh.n_nodes), jnp.float32)
        fit_kappa(mesh, f, f * 0.01, steps=1, eval_final=False)
        assert seen[0][3] == 9

    @pytest.mark.parametrize("dim", [0, 4])
    def test_unknown_dim_raises(self, dim):
        with pytest.raises(ValueError, match="dim"):
            fit_route(dim, "gpu")

    @pytest.mark.parametrize("dim", [1, 2, 3])
    def test_fit_kappa_reports_the_route_of_this_backend(self, dim):
        mesh = {1: FEMesh.line(6, dtype=jnp.float32),
                2: FEMesh.rectangle(3, 3, dtype=jnp.float32),
                3: FEMesh.box(2, 2, 2, dtype=jnp.float32)}[dim]
        f = jnp.ones((2, mesh.n_nodes), jnp.float32)
        u = solve_poisson_batched(mesh, jnp.full((2,), 1.5), f,
                                  kappa_batched=True)
        _, info = fit_kappa(mesh, f, u, steps=2, eval_final=False)
        assert info["path"] == fit_route(dim, jax.default_backend())


class TestRemovedOptions:
    @pytest.mark.parametrize("method", ["tridiag_pallas", "pallas"])
    def test_solve_method_raises(self, method):
        mesh = FEMesh.line(8)
        with pytest.raises(ValueError, match="Unknown method"):
            solve_poisson(mesh, 1.0, jnp.ones(mesh.n_nodes), method=method)

    def test_batched_tridiag_pallas_raises(self):
        mesh = FEMesh.line(8)
        with pytest.raises(ValueError, match="Unknown method"):
            solve_poisson_batched(mesh, jnp.ones((3, 8)),
                                  jnp.ones((3, mesh.n_nodes)),
                                  method="tridiag_pallas")

    @pytest.mark.parametrize("backend", ["pallas", "mxu"])
    def test_tridiag_backend_raises(self, backend):
        from difffe_tpu.ops.assembly import assemble_tridiag_1d
        from difffe_tpu.ops.tridiag import solve_poisson_tridiag
        mesh = FEMesh.line(8)
        d, e = assemble_tridiag_1d(mesh, 1.0)
        with pytest.raises(ValueError, match="unknown tridiagonal backend"):
            solve_poisson_tridiag(mesh, d, e, jnp.ones(mesh.n_nodes),
                                  backend=backend)

    def test_spike_backend_still_solves(self):
        from difffe_tpu.ops.assembly import assemble_tridiag_1d
        from difffe_tpu.ops.tridiag import solve_poisson_tridiag
        mesh = FEMesh.line(64)
        d, e = assemble_tridiag_1d(mesh, 1.0)
        F = jnp.ones((2, mesh.n_nodes)) / 64
        u_s = solve_poisson_tridiag(mesh, d, e, F, backend="spike",
                                    chunk=16)
        u_x = solve_poisson_tridiag(mesh, d, e, F)
        np.testing.assert_allclose(np.asarray(u_s), np.asarray(u_x),
                                   atol=1e-12)

    @pytest.mark.parametrize("kw", ["block_b", "operand_dtype",
                                    "cumsum_via", "block_lanes", "version",
                                    "refine"])
    def test_fit_kappa_rejects_kernel_options(self, kw):
        mesh = FEMesh.rectangle(3, 3)
        f = jnp.ones((1, mesh.n_nodes))
        with pytest.raises(TypeError, match=kw):
            fit_kappa(mesh, f, f, steps=1, **{kw: 1})

    @pytest.mark.parametrize("name", [
        "choose_3d_grad_step", "choose_3d_block_b", "choose_2d_path",
        "fused_kappa_mse_step_3d_pallas"])
    def test_dispatch_tables_are_gone(self, name):
        import difffe_tpu
        from difffe_tpu.ops import stencil3d
        assert not hasattr(stencil3d, name)
        with pytest.raises(AttributeError):
            getattr(difffe_tpu, name)


class TestCompileCache:
    def test_env_var_wins_and_nothing_is_set(self, monkeypatch, tmp_path):
        from difffe_tpu.utils.compile_cache import configure_compile_cache
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert configure_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_unset_uses_fixed_checkout_path(self, monkeypatch):
        from difffe_tpu.utils import compile_cache
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        try:
            got = compile_cache.configure_compile_cache()
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            # fixed: a second call (another process) names the same path
            assert compile_cache.configure_compile_cache() == got
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_checkout_cache_is_gitignored(self):
        with open(os.path.join(REPO, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()


class TestChipSmokePhases:
    """Each phase of chip_smoke.py at a tiny size on the CPU: the same
    fit_kappa calls and float64 reference checks the card runs."""

    def test_reference_p1_matches_dense_solver(self):
        import chip_smoke as cs
        mesh = FEMesh.rectangle(5, 4)
        rng = np.random.default_rng(0)
        k = rng.uniform(0.5, 2.0, mesh.n_elements)
        f = rng.normal(size=mesh.n_nodes)
        ud = rng.normal(size=mesh.n_nodes)
        u_ref, g_ref = cs.ref_solve_grad(mesh.nodes, mesh.elements,
                                         mesh.bc_mask, mesh.bc_values, k, f,
                                         ud)
        u = solve_poisson(mesh, jnp.asarray(k), jnp.asarray(f),
                          method="dense")
        g = jax.grad(lambda kk: 0.5 * jnp.sum((solve_poisson(
            mesh, kk, jnp.asarray(f), method="dense") - ud) ** 2))(
                jnp.asarray(k))
        np.testing.assert_allclose(np.asarray(u), u_ref, atol=1e-12)
        np.testing.assert_allclose(np.asarray(g), g_ref, atol=1e-12)

    def test_reference_p1_tets_match_dense_solver(self):
        import chip_smoke as cs
        mesh = FEMesh.box(2, 2, 3)
        rng = np.random.default_rng(1)
        k = rng.uniform(0.5, 2.0, mesh.n_elements)
        f = rng.normal(size=mesh.n_nodes)
        u_ref, _ = cs.ref_solve_grad(mesh.nodes, mesh.elements,
                                     mesh.bc_mask, mesh.bc_values, k, f,
                                     np.zeros(mesh.n_nodes))
        u = solve_poisson(mesh, jnp.asarray(k), jnp.asarray(f),
                          method="dense")
        np.testing.assert_allclose(np.asarray(u), u_ref, atol=1e-12)

    @pytest.mark.parametrize("ne,B", [(30, 40), (7, 3)])
    def test_phase_1d(self, ne, B):
        import chip_smoke as cs
        info = cs.phase_1d(ne, B, steps=40, parity_batch=8,
                           log=lambda *_: None, interpret=True)
        assert info["path"] == "cf_xla"

    def test_phase_2d(self):
        import chip_smoke as cs
        info = cs.phase_2d(6, 3, steps=8, parity=2, maxiter=200,
                           log=lambda *_: None)
        assert info["iters"] == 32 and info["warm"] is True

    def test_phase_2d_batched(self):
        import chip_smoke as cs
        cs.phase_2d_batched(6, 3, iters=32, parity_iters=200,
                            log=lambda *_: None)

    def test_phase_3d(self):
        import chip_smoke as cs
        info = cs.phase_3d(3, 3, steps=3, parity=2, maxiter=100,
                           log=lambda *_: None)
        assert info["warm"] is False

    def test_phase_unstructured(self):
        import chip_smoke as cs
        info = cs.phase_unstructured(5, 128, steps=4, parity=2,
                                     maxiter=200, log=lambda *_: None)
        assert info["path"] == "generic_ell_batchminor"

    def test_phase_multi_on_virtual_devices(self):
        import chip_smoke as cs
        assert len(jax.devices()) >= 4          # conftest: 8 CPU devices
        cs.phase_multi(n_dev=4, n2d=16, batch=8, n3d=6,
                       log=lambda *_: None)

    def test_parity_check_raises_past_its_limit(self):
        import chip_smoke as cs
        cs.check("ok", 1e-6, 1e-5, log=lambda *_: None)
        with pytest.raises(AssertionError, match="parity"):
            cs.check("bad", 2e-5, 1e-5, log=lambda *_: None)

    def test_main_refuses_without_gpu(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "needs a GPU" in r.stderr
