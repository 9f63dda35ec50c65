"""Closed-form prefix-sum general-κ path (ops/cf1d.py + the Pallas-Triton
chain kernel ops/pallas/fused_grad_cf_kernel.py): exact solve parity vs
the tridiag path, gradient parity vs a float64 banded reference, the
chain kernel (interpret mode) vs sequential XLA steps, packing and
padding, the 1D route, and the scope guards."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from difffe_tpu.mesh import FEMesh
from difffe_tpu.ops.assembly import assemble_load
from difffe_tpu.ops.cf1d import (
    kappa_mse_step_cf,
    mesh_supports_cf,
    solve_poisson_cf_batched,
)
from difffe_tpu.ops.pallas import fused_grad_cf_kernel as cfk
from difffe_tpu.ops.pallas.fused_grad_cf_kernel import (
    cf_packed_operands,
    cf_unpack,
    kappa_sgd_chain_cf,
)
from difffe_tpu.solver import solve_poisson_batched


def _setup(n=30, B=16, dtype=jnp.float32, bc=(0.4, -0.1), seed=0,
           nonuniform=False):
    mesh = FEMesh.line(n_elements=n, dtype=dtype, bc_left=bc[0],
                       bc_right=bc[1])
    if nonuniform:
        xs = (jnp.asarray(mesh.nodes)[:, 0] ** 1.5).reshape(-1, 1)
        mesh = dataclasses.replace(mesh, nodes=xs.astype(dtype))
    x = mesh.nodes[:, 0]
    fv = (jnp.sin(jnp.pi * x) + 1.0).astype(dtype)
    key = jax.random.PRNGKey(seed)
    ke_true = 1.0 + jax.random.uniform(key, (B, n), dtype)
    fB = jnp.broadcast_to(fv, (B, mesh.n_nodes))
    u_data = solve_poisson_batched(mesh, ke_true, fB, method="tridiag")
    ke0 = 1.0 + 0.3 * jax.random.uniform(jax.random.PRNGKey(seed + 1),
                                         (B, n), dtype)
    return mesh, fv, fB, u_data, ke0


def _ref_grad(mesh, fB, u_data, ke):
    def loss(k):
        u = solve_poisson_batched(mesh, k, fB, method="tridiag")
        return jnp.mean((u - u_data) ** 2)
    return jax.value_and_grad(loss)(ke)


class TestClosedFormXLA:
    @pytest.mark.parametrize("nonuniform", [False, True])
    def test_solve_matches_tridiag(self, nonuniform):
        mesh, fv, fB, u_data, ke0 = _setup(nonuniform=nonuniform)
        u_ref = solve_poisson_batched(mesh, ke0, fB, method="tridiag")
        u_cf = solve_poisson_cf_batched(mesh, ke0, fB)
        np.testing.assert_allclose(np.asarray(u_cf), np.asarray(u_ref),
                                   rtol=2e-5, atol=2e-6)

    def test_solve_batched_bc_values(self):
        mesh, fv, fB, u_data, ke0 = _setup(B=6)
        B = 6
        bv = jnp.zeros((B, mesh.n_nodes), mesh.dtype)
        bv = bv.at[:, 0].set(jnp.linspace(-1.0, 1.0, B,
                                          dtype=mesh.dtype))
        bv = bv.at[:, -1].set(0.5)
        u_ref = solve_poisson_batched(mesh, ke0, fB, method="tridiag",
                                      bc_values=bv)
        u_cf = solve_poisson_cf_batched(mesh, ke0, fB, bc_values=bv)
        np.testing.assert_allclose(np.asarray(u_cf), np.asarray(u_ref),
                                   rtol=2e-5, atol=2e-6)

    @pytest.mark.parametrize("nonuniform", [False, True])
    def test_autodiff_grad_matches_tridiag(self, nonuniform):
        mesh, fv, fB, u_data, ke0 = _setup(nonuniform=nonuniform)

        def loss_cf(k):
            u = solve_poisson_cf_batched(mesh, k, fB)
            return jnp.mean((u - u_data) ** 2)

        _, g_ref = _ref_grad(mesh, fB, u_data, ke0)
        g_cf = jax.grad(loss_cf)(ke0)
        np.testing.assert_allclose(np.asarray(g_cf), np.asarray(g_ref),
                                   rtol=1e-3, atol=1e-8)

    @pytest.mark.parametrize("nonuniform", [False, True])
    def test_fused_step_matches_xla(self, nonuniform):
        mesh, fv, fB, u_data, ke0 = _setup(nonuniform=nonuniform)
        B, n = 16, mesh.n_nodes
        loss_ref, g_ref = _ref_grad(mesh, fB, u_data, ke0)
        Fs = assemble_load(mesh, fv)
        lp, gk = kappa_mse_step_cf(mesh, ke0, Fs, u_data)
        np.testing.assert_allclose(float(lp.sum() / (B * n)),
                                   float(loss_ref), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(gk), np.asarray(g_ref),
                                   rtol=1e-3, atol=1e-8)

    def test_supports_predicate(self):
        mesh, *_ = _setup()
        assert mesh_supports_cf(mesh)
        assert not mesh_supports_cf(FEMesh.rectangle(4, 4))
        assert not mesh_supports_cf(FEMesh.line_p2(8))
        one_sided = FEMesh.line(8, dirichlet_right=False) \
            if "dirichlet_right" in FEMesh.line.__code__.co_varnames \
            else None
        if one_sided is not None:
            assert not mesh_supports_cf(one_sided)

    def test_interior_dirichlet_raises(self):
        mesh, fv, fB, u_data, ke0 = _setup()
        m = jnp.asarray(mesh.bc_mask).at[5].set(1.0)
        mesh2 = dataclasses.replace(mesh, bc_mask=m)
        with pytest.raises(ValueError):
            solve_poisson_cf_batched(mesh2, ke0, fB)


def _xla_steps(mesh, ke, Fs, u_data, k, lr, scale):
    """k sequential XLA closed-form SGD steps; returns (κ, last loss)."""
    lp = None
    for _ in range(k):
        lp, g = kappa_mse_step_cf(mesh, ke, Fs, u_data, scale=scale)
        ke = ke - lr * g
    return ke, lp


def _chain(mesh, ke, Fs, u_data, k, lr, scale=None):
    keP, ops = cf_packed_operands(mesh, ke, Fs, u_data)
    lp, keP = kappa_sgd_chain_cf(keP, ops, k, lr, scale=scale,
                                 interpret=True)
    return cf_unpack(keP, ops), lp, keP, ops


def _ref_grad_f64(mesh, fv, u_data, ke, scale):
    """∂/∂κ of scale/2·Σ(u − u_data)² from banded float64 solves."""
    from chip_smoke import ref_line_grad
    x = np.asarray(mesh.nodes[:, 0], np.float64)
    h = np.diff(x)
    fv = np.asarray(fv, np.float64)
    F = np.zeros_like(x)
    F[:-1] += h / 2 * fv[:-1]
    F[1:] += h / 2 * fv[1:]
    bc = np.asarray(mesh.bc_values, np.float64)
    return ref_line_grad(x, np.asarray(ke), F, np.asarray(u_data),
                         bc[0], bc[-1], scale)[1]


class TestChainKernel:
    """The chain kernel in interpret mode (the same jaxpr that Triton
    compiles on a GPU; tests marked gpu compile it for real)."""

    @pytest.mark.parametrize("k", [1, 5, 32])
    @pytest.mark.parametrize("n", [1, 2, 7, 30, 31, 128])
    def test_chain_matches_xla_steps(self, n, k):
        B = 5 if n == 128 else 13
        mesh, fv, fB, u_data, ke0 = _setup(n=n, B=B)
        Fs = assemble_load(mesh, fv)
        lr, scale = 3.0, 2.0 / mesh.n_nodes
        k_chain, lp, _, _ = _chain(mesh, ke0, Fs, u_data, k, lr, scale)
        k_seq, lp_seq = _xla_steps(mesh, ke0, Fs, u_data, k, lr, scale)
        np.testing.assert_allclose(np.asarray(k_chain), np.asarray(k_seq),
                                   rtol=2e-6, atol=2e-6)
        # loss of the last inner step's κ (before its update)
        np.testing.assert_allclose(np.asarray(lp), np.asarray(lp_seq),
                                   rtol=2e-5, atol=1e-9)

    @pytest.mark.parametrize("n", [2, 30, 31])
    def test_one_step_grad_matches_f64_reference(self, n):
        mesh, fv, fB, u_data, ke0 = _setup(n=n, B=6, dtype=jnp.float64)
        Fs = assemble_load(mesh, fv)
        scale = 2.0 / mesh.n_nodes
        g_ref = _ref_grad_f64(mesh, fv, u_data, ke0, scale)
        k1, _, _, _ = _chain(mesh, ke0, Fs, u_data, 1, 1.0, scale)
        np.testing.assert_allclose(np.asarray(ke0 - k1), g_ref,
                                   rtol=1e-9, atol=1e-14)

    @pytest.mark.parametrize("nonuniform", [False, True])
    @pytest.mark.parametrize("shared_ud", [False, True])
    def test_grad_parity(self, nonuniform, shared_ud):
        mesh, fv, fB, u_data, ke0 = _setup(B=40, dtype=jnp.float64,
                                           nonuniform=nonuniform)
        if shared_ud:
            u_data = jnp.broadcast_to(u_data[0], u_data.shape)
        Fs = assemble_load(mesh, fv)
        scale = 2.0 / (40 * mesh.n_nodes)
        g_ref = _ref_grad_f64(mesh, fv, u_data, ke0, scale)
        ud_arg = u_data[0] if shared_ud else u_data
        k1, _, _, _ = _chain(mesh, ke0, Fs, ud_arg, 1, 1.0)
        np.testing.assert_allclose(np.asarray(ke0 - k1), g_ref,
                                   rtol=1e-9, atol=1e-15)

    @pytest.mark.parametrize("B,rows", [(37, 8), (70, 16), (100, 16)])
    def test_ragged_batch_pads_rows(self, B, rows, monkeypatch):
        """B not a multiple of the block rows: padded rows (κ = 1, zero
        observations) never leak into the real scenarios."""
        monkeypatch.setattr(cfk, "_MIN_BLOCKS", 4)
        mesh, fv, fB, u_data, ke0 = _setup(n=30, B=B)
        Fs = assemble_load(mesh, fv)
        k_chain, lp, keP, ops = _chain(mesh, ke0, Fs, u_data, 5, 3.0)
        assert ops.rows == rows and keP.shape[0] % rows == 0
        assert B < keP.shape[0] < B + rows
        k_seq, _ = _xla_steps(mesh, ke0, Fs, u_data, 5, 3.0,
                              2.0 / (B * mesh.n_nodes))
        np.testing.assert_allclose(np.asarray(k_chain), np.asarray(k_seq),
                                   rtol=2e-6, atol=2e-6)
        assert lp.shape == (B,)

    @pytest.mark.parametrize("n", [1, 7, 16, 30, 31, 33, 128])
    def test_packing_layout(self, n):
        mesh, fv, fB, u_data, ke0 = _setup(n=n, B=3)
        keP, ops = cf_packed_operands(mesh, ke0, assemble_load(mesh, fv),
                                      u_data)
        N = keP.shape[1]
        assert N >= max(n, 16) and N & (N - 1) == 0      # power of two
        hs, pf, dm, rm = np.asarray(ops.consts)
        np.testing.assert_allclose(hs[:n], np.diff(
            np.asarray(mesh.nodes[:, 0])), rtol=1e-6)
        assert np.all(hs[n:] == 0) and np.all(pf[n:] == 0)
        assert dm.sum() == n and rm.sum() == n - 1
        assert np.all(np.asarray(keP)[:, n:] == 1.0)
        np.testing.assert_array_equal(np.asarray(cf_unpack(keP, ops)),
                                      np.asarray(ke0))
        np.testing.assert_array_equal(np.asarray(ops.udP)[:3, :n],
                                      np.asarray(u_data)[:, 1:])

    @pytest.mark.parametrize("N,B,rows,warps", [
        (32, 2_097_152, 64, 8), (128, 1024, 2, 2), (32, 1023, 1, 1),
        (16, 5, 1, 1), (1024, 1 << 20, 2, 8)])
    def test_launch_config(self, N, B, rows, warps):
        assert cfk._launch_config(N, B) == (rows, warps)

    def test_chain_descends(self):
        mesh, fv, fB, u_data, ke0 = _setup(B=64)
        Fs = assemble_load(mesh, fv)
        keP, ops = cf_packed_operands(mesh, ke0, Fs, u_data)
        lp0, keP1 = kappa_sgd_chain_cf(keP, ops, 1, 30.0, interpret=True)
        lp1, _ = kappa_sgd_chain_cf(keP1, ops, 30, 30.0, interpret=True)
        assert float(lp1.sum()) < float(lp0.sum())

    def test_n_inner_zero_raises(self):
        mesh, fv, fB, u_data, ke0 = _setup(B=2)
        keP, ops = cf_packed_operands(mesh, ke0, assemble_load(mesh, fv),
                                      u_data)
        with pytest.raises(ValueError, match="n_inner"):
            kappa_sgd_chain_cf(keP, ops, 0, 1.0, interpret=True)

    def test_batched_F_raises(self):
        mesh, fv, fB, u_data, ke0 = _setup()
        FB = assemble_load(mesh, fB)
        with pytest.raises(ValueError, match="shared"):
            cf_packed_operands(mesh, ke0, FB, u_data)

    def test_general_mask_raises(self):
        mesh, fv, fB, u_data, ke0 = _setup()
        m = jnp.asarray(mesh.bc_mask).at[5].set(1.0)
        mesh2 = dataclasses.replace(mesh, bc_mask=m)
        Fs = assemble_load(mesh, fv)
        with pytest.raises(ValueError, match="endpoint"):
            cf_packed_operands(mesh2, ke0, Fs, u_data)

    @pytest.mark.parametrize("kw", ["block_lanes", "cumsum_via",
                                    "operand_dtype"])
    def test_removed_kernel_options_are_rejected(self, kw):
        mesh, fv, fB, u_data, ke0 = _setup(B=2)
        with pytest.raises(TypeError, match=kw):
            cf_packed_operands(mesh, ke0, assemble_load(mesh, fv), u_data,
                               **{kw: 1})

    @pytest.mark.gpu
    def test_compiled_chain_matches_xla(self, gpu_device):
        mesh, fv, fB, u_data, ke0 = _setup(n=30, B=1024)
        Fs = assemble_load(mesh, fv)
        keP, ops = cf_packed_operands(mesh, ke0, Fs, u_data)
        _, keP = kappa_sgd_chain_cf(keP, ops, 32, 3.0)
        k_seq, _ = _xla_steps(mesh, ke0, Fs, u_data, 32, 3.0,
                              2.0 / (1024 * mesh.n_nodes))
        np.testing.assert_allclose(np.asarray(cf_unpack(keP, ops)),
                                   np.asarray(k_seq), rtol=1e-5, atol=1e-6)


class TestFitKappa1D:
    def test_fit_kappa_routes_cf_chain_and_descends(self):
        from difffe_tpu.inverse import _fit_kappa_1d
        mesh, fv, fB, u_data, ke0 = _setup(B=8, bc=(0.0, 0.0))
        k, info = _fit_kappa_1d(mesh, fB, u_data, 40, None, None, True,
                                route="cf_chain_triton", interpret=True)
        assert info["path"] == "cf_chain_triton"
        assert k.shape == (8, mesh.n_elements)
        # history entries are per-launch LAST-step losses (already 32
        # steps in) — assert continued descent, not a fixed drop factor
        assert info["eval_loss"] < float(info["loss_history"][0])
        # per-launch history: ceil(40/32) = 2 entries
        assert info["loss_history"].shape == (2,)
        assert float(info["loss_history"][1]) < \
            float(info["loss_history"][0])

    def test_chain_route_matches_xla_route(self):
        from difffe_tpu.inverse import _fit_kappa_1d
        mesh, fv, fB, u_data, ke0 = _setup(B=8, bc=(0.3, -0.2))
        kc, ic = _fit_kappa_1d(mesh, fB, u_data, 70, None, None, True,
                               route="cf_chain_triton", interpret=True)
        kx, ix = _fit_kappa_1d(mesh, fB, u_data, 70, None, None, True,
                               route="cf_xla")
        np.testing.assert_allclose(np.asarray(kc), np.asarray(kx),
                                   rtol=1e-5)
        np.testing.assert_allclose(ic["eval_loss"], ix["eval_loss"],
                                   rtol=1e-4)
        # chain history holds each launch's last step: steps 32, 64, 70
        np.testing.assert_allclose(
            np.asarray(ic["loss_history"]),
            np.asarray(ix["loss_history"])[jnp.array([31, 63, 69])],
            rtol=1e-4)

    def test_fit_kappa_on_cpu_takes_xla_route(self):
        from difffe_tpu import fit_kappa
        mesh, fv, fB, u_data, ke0 = _setup(B=8, bc=(0.0, 0.0))
        k, info = fit_kappa(mesh, fB, u_data, steps=40)
        assert info["path"] == "cf_xla"
        assert info["loss_history"].shape == (40,)
        assert info["eval_loss"] < float(info["loss_history"][0])

    def test_chain_route_rejects_per_scenario_forcing(self):
        from difffe_tpu.inverse import _fit_kappa_1d
        mesh, fv, fB, u_data, ke0 = _setup(B=4)
        fB2 = fB * jnp.arange(1.0, 5.0)[:, None]
        with pytest.raises(ValueError, match="shared forcing"):
            _fit_kappa_1d(mesh, fB2, u_data, 5, None, None, False,
                          route="cf_chain_triton", interpret=True)

    def test_unknown_route_raises(self):
        from difffe_tpu.inverse import _fit_kappa_1d
        mesh, fv, fB, u_data, ke0 = _setup(B=2)
        with pytest.raises(ValueError, match="unknown 1D fit route"):
            _fit_kappa_1d(mesh, fB, u_data, 5, None, None, False,
                          route="cf_chain_pallas")

    def test_fit_kappa_per_scenario_forcing_routes_xla(self):
        from difffe_tpu import fit_kappa
        mesh, fv, fB, u_data, ke0 = _setup(B=4, bc=(0.0, 0.0))
        key = jax.random.PRNGKey(9)
        fB2 = fB * (1.0 + 0.3 * jax.random.uniform(key, (4, 1)))
        ke_true = 1.0 + jax.random.uniform(key, (4, mesh.n_elements),
                                           mesh.dtype)
        from difffe_tpu.solver import solve_poisson_batched as spb
        ud2 = spb(mesh, ke_true, fB2, method="tridiag")
        k, info = fit_kappa(mesh, fB2, ud2, steps=30)
        assert info["path"] == "cf_xla"
        assert info["loss_history"].shape == (30,)
        assert info["eval_loss"] < 0.2 * float(info["loss_history"][0])

    def test_fit_kappa_1d_noncf_mesh_falls_back(self):
        from difffe_tpu import fit_kappa
        mesh, fv, fB, u_data, ke0 = _setup(B=2)
        m = jnp.asarray(mesh.bc_mask).at[5].set(1.0)
        bv = jnp.asarray(mesh.bc_values).at[5].set(0.0)
        mesh2 = dataclasses.replace(mesh, bc_mask=m, bc_values=bv)
        k, info = fit_kappa(mesh2, fB, u_data, steps=5)
        assert info["path"] == "generic_adam"
