"""Smoke test of the κ-inversion path on one GPU.

Drives ``fit_kappa`` — the call behind ``python -m difffe_tpu.cli invert``
— end to end at the sizes its users run, and checks each result against a
plain float64 reference written here in numpy/scipy, independent of the
package's assembly and stencil code:

* 1D: ``FEMesh.line(30)`` × B = 2,097,152 and ``FEMesh.line(128)`` ×
  B = 1024 (BASELINE.json config 2), shared forcing, 64 SGD steps; the
  first-step κ-gradient against a banded f64 solve, and on a GPU the
  Pallas-Triton chain kernel against the XLA closed form;
* 2D: ``FEMesh.rectangle(64, 64)`` × B = 256, default warm-32 policy,
  32 steps; then the batched fixed-trip facade solves (Dirichlet and
  Neumann, 128 CG iterations);
* 3D: ``FEMesh.box(32, 32, 32)`` × B = 128, default 100 iterations,
  8 steps;
* unstructured: the ``cli invert --dim 2 --unstructured`` workload at
  B = 128 (edge-ELL route).

2D, 3D and unstructured compare a converged solve and its adjoint
κ-gradient, on a few scenarios, with a scipy.sparse f64 solve of a P1
stiffness assembled here from ``mesh.nodes``/``mesh.elements``.  The
device side runs in float32; f32 matmuls in the references' device
counterparts run at "highest" precision.  Every check raises on failure;
nothing is caught.

    python chip_smoke.py            # one GPU, every phase above
    python chip_smoke.py --multi    # four GPUs: sharded vs one device (f64)

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


# ---------------------------------------------------------------------------
# Plain float64 references (numpy / scipy only)
# ---------------------------------------------------------------------------

def ref_line_grad(x, kappa, F, u_data, u_l, u_r, scale):
    """1D P1 chain with Dirichlet ends, per-element κ (B, ne), assembled
    load F (n,), observations (B, n).  Returns (u (B, n), ∂/∂κ of
    scale/2·Σ(u − u_data)²) from a banded forward and adjoint solve."""
    from scipy.linalg import solve_banded

    h = np.diff(np.asarray(x, np.float64))
    kappa = np.asarray(kappa, np.float64)
    F = np.asarray(F, np.float64)
    u_data = np.asarray(u_data, np.float64)
    B, ne = kappa.shape
    us, gs = [], []
    for b in range(B):
        c = kappa[b] / h                                # element conductance
        diag = c[:-1] + c[1:]                           # interior rows
        ab = np.zeros((3, ne - 1))
        ab[0, 1:] = -c[1:-1]
        ab[1] = diag
        ab[2, :-1] = -c[1:-1]
        rhs = F[1:-1].copy()
        rhs[0] += c[0] * u_l
        rhs[-1] += c[-1] * u_r
        u = np.concatenate([[u_l], solve_banded((1, 1), ab, rhs), [u_r]])
        lam = np.concatenate(
            [[0.0], solve_banded((1, 1), ab, scale * (u - u_data[b])[1:-1]),
             [0.0]])
        gs.append(-np.diff(lam) * np.diff(u) / h)
        us.append(u)
    return np.array(us), np.array(gs)


def _p1_local(nodes, elements):
    """Per-element volumes (ne,) and barycentric gradients (ne, d+1, d)."""
    X = np.asarray(nodes, np.float64)[np.asarray(elements)]
    ne, k, d = X.shape
    M = np.concatenate([np.ones((ne, k, 1)), X], axis=2)
    Minv = np.linalg.inv(M)
    vol = np.abs(np.linalg.det(M)) / float(np.prod(np.arange(1, d + 1)))
    return vol, np.transpose(Minv[:, 1:, :], (0, 2, 1))


def p1_stiffness(nodes, elements, kappa):
    """Sparse P1 stiffness Σ_e κ_e·vol_e·G_e G_eᵀ (CSR, float64)."""
    import scipy.sparse as sp

    el = np.asarray(elements)
    vol, G = _p1_local(nodes, el)
    Ke = (np.asarray(kappa, np.float64) * vol)[:, None, None] \
        * np.einsum("eid,ejd->eij", G, G)
    k = el.shape[1]
    rows = np.repeat(el[:, :, None], k, axis=2).ravel()
    cols = np.repeat(el[:, None, :], k, axis=1).ravel()
    n = len(nodes)
    return sp.csr_matrix((Ke.ravel(), (rows, cols)), shape=(n, n))


def p1_load(nodes, elements, f):
    """Centroid-rule load: node p gets vol_e/(d+1)·mean(f over e)."""
    el = np.asarray(elements)
    vol, _ = _p1_local(nodes, el)
    f = np.asarray(f, np.float64)
    contrib = vol / el.shape[1] * f[el].mean(axis=1)
    return np.bincount(el.ravel(), np.repeat(contrib, el.shape[1]),
                       minlength=len(nodes))


def ref_solve_grad(nodes, elements, bc_mask, bc_values, kappa, f, u_data,
                   extra_load=None):
    """Dirichlet-eliminated P1 solve and ∂/∂κ of ½Σ(u − u_data)², one
    scenario, sparse direct float64.  Returns (u, grad (ne,))."""
    from scipy.sparse.linalg import spsolve

    el = np.asarray(elements)
    K = p1_stiffness(nodes, el, kappa)
    F = p1_load(nodes, el, f)
    if extra_load is not None:
        F = F + np.asarray(extra_load, np.float64)
    fixed = np.asarray(bc_mask) > 0.5
    free = ~fixed
    u = np.where(fixed, np.asarray(bc_values, np.float64), 0.0)
    Kff = K[free][:, free]
    u[free] = spsolve(Kff, F[free] - K[free][:, fixed] @ u[fixed])
    lam = np.zeros_like(u)
    lam[free] = spsolve(Kff, (u - np.asarray(u_data, np.float64))[free])
    vol, G = _p1_local(nodes, el)
    Ke1 = vol[:, None, None] * np.einsum("eid,ejd->eij", G, G)
    grad = -np.einsum("ei,eij,ej->e", lam[el], Ke1, u[el])
    return u, grad


def rel_err(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


def check(name: str, value: float, limit: float, log=print) -> None:
    log(f"  parity {name}: {value:.3e} (limit {limit:.0e})")
    if not value <= limit:
        raise AssertionError(f"{name} parity {value:.3e} > {limit:.0e}")


# ---------------------------------------------------------------------------
# Phases (sizes are arguments, so tests can run them tiny on the CPU)
# ---------------------------------------------------------------------------

def memory_line(name, jitted, *args, log=print, **kwargs) -> None:
    """Compiled memory footprint of one phase's step."""
    ma = jitted.lower(*args, **kwargs).compile().memory_analysis()
    if ma is None:
        log(f"  memory {name}: not reported by this backend")
        return
    log(f"  memory {name}: args {ma.argument_size_in_bytes} B, "
        f"out {ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B")


def peak_line(log=print) -> None:
    import jax

    stats = jax.devices()[0].memory_stats()
    peak = None if stats is None else stats.get("peak_bytes_in_use")
    log(f"  device peak_bytes_in_use: "
        f"{'not reported' if peak is None else peak}")


def _falls(name, info, log=print) -> None:
    hist = np.asarray(info["loss_history"], np.float64)
    log(f"  {name}: path={info['path']} iters={info['iters']} "
        f"warm={info['warm']} loss {hist[0]:.6e} -> {hist[-1]:.6e} "
        f"eval {info['eval_loss']:.6e}")
    if not (np.all(np.isfinite(hist)) and hist[-1] < hist[0]
            and np.isfinite(info["eval_loss"])):
        raise AssertionError(f"{name}: loss did not fall: {hist}")


def phase_1d(n_elements: int, batch: int, steps: int = 64,
             parity_batch: int = 64, log=print, interpret: bool = False):
    """fit_kappa on FEMesh.line(n_elements) × batch, shared forcing."""
    import jax
    import jax.numpy as jnp

    from difffe_tpu.cli import invert_workload
    from difffe_tpu.inverse import fit_kappa, fit_route
    from difffe_tpu.ops.assembly import assemble_load
    from difffe_tpu.ops.cf1d import cf_step
    from difffe_tpu.ops.pallas.fused_grad_cf_kernel import (
        cf_packed_operands, cf_unpack, kappa_sgd_chain_cf)

    mesh, fB, u_data, _ = invert_workload(1, n_elements, batch)
    t0 = time.perf_counter()
    kappa, info = fit_kappa(mesh, fB, u_data, steps=steps)
    jax.block_until_ready(kappa)
    log(f"1D line({n_elements}) B={batch} steps={steps}: "
        f"{time.perf_counter() - t0:.2f} s incl. compile")
    _falls("1D", info, log)
    route = fit_route(1, jax.default_backend(), n_elements=n_elements)
    assert info["path"] == route, (info["path"], route)
    assert kappa.shape == (batch, n_elements)

    # first-step κ-gradient on the first scenarios vs banded f64 solves
    S = min(parity_batch, batch)
    n = mesh.n_nodes
    x = np.asarray(mesh.nodes[:, 0], np.float64)
    F = assemble_load(mesh, fB[0])
    F_ref = np.zeros(n)                                 # trapezoidal rule
    h = np.diff(x)
    fv = np.asarray(fB[0], np.float64)
    F_ref[:-1] += h / 2 * fv[:-1]
    F_ref[1:] += h / 2 * fv[1:]
    ud = u_data[:S]
    ke = jnp.ones((S, n_elements), jnp.float32)
    scale = 2.0 / n
    _, g_ref = ref_line_grad(x, np.ones((S, n_elements)), F_ref,
                             np.asarray(ud), 0.0, 0.0, scale)
    hs = jnp.asarray(h, jnp.float32)
    step = jax.jit(lambda k: cf_step(hs, k, F, ud, 0.0, 0.0, scale))
    _, g_xla = step(ke)
    check("1D xla grad vs f64 (f32)", rel_err(g_xla, g_ref), 1e-4, log)
    memory_line("1D xla step", step, ke, log=log)

    if route == "cf_chain_triton" or interpret:
        keP, ops = cf_packed_operands(mesh, ke, F, ud)
        lr_probe = 0.5 / float(np.max(np.abs(g_ref)))
        chain = jax.jit(lambda k, o, n_inner, lr: kappa_sgd_chain_cf(
            k, o, n_inner, lr, scale=scale, interpret=interpret),
            static_argnums=(2, 3))
        _, keP1 = chain(keP, ops, 1, lr_probe)
        g_chain = (ke - cf_unpack(keP1, ops)) / lr_probe
        check("1D chain grad vs f64 (f32)", rel_err(g_chain, g_ref), 1e-4,
              log)
        _, keP32 = chain(keP, ops, 32, 30.0)
        k_xla = ke
        for _ in range(32):
            k_xla = k_xla - 30.0 * step(k_xla)[1]
        check("1D chain vs xla, 32 steps (same f32 inputs)",
              rel_err(cf_unpack(keP32, ops), k_xla), 1e-5, log)
        memory_line("1D chain launch (32 steps)", chain, keP, ops, 32,
                    30.0, log=log)
    peak_line(log)
    return info


def _structured_parity(mesh, kappa, fB, u_data, S, maxiter, log, label):
    """Converged facade solve + its adjoint κ-gradient on S scenarios vs
    the scipy f64 reference."""
    import jax
    import jax.numpy as jnp

    from difffe_tpu.solver import solve_poisson_batched

    k, f, ud = kappa[:S], fB[:S], u_data[:S]

    def loss(kk):
        u = solve_poisson_batched(mesh, kk, f, cg_tol=0.0,
                                  cg_maxiter=maxiter)
        return 0.5 * jnp.sum((u - ud) ** 2), u

    with jax.default_matmul_precision("highest"):
        (_, u), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(k)
    refs = [ref_solve_grad(mesh.nodes, mesh.elements, mesh.bc_mask,
                           mesh.bc_values, k[b], f[b], ud[b])
            for b in range(S)]
    check(f"{label} u vs f64 (f32 CG, {maxiter} it)",
          rel_err(u, [r[0] for r in refs]), 1e-4, log)
    check(f"{label} grad vs f64 (f32 CG adjoint)",
          rel_err(g, [r[1] for r in refs]), 1e-3, log)
    return refs


def phase_2d(n: int, batch: int, steps: int = 32, parity: int = 3,
             maxiter: int = 1024, log=print):
    """fit_kappa on FEMesh.rectangle(n, n) × batch, default policy."""
    import jax
    import jax.numpy as jnp

    from difffe_tpu.cli import invert_workload
    from difffe_tpu.inverse import fit_kappa, fit_route
    from difffe_tpu.ops.stencil import (kappa_lu_from_elements,
                                        kappa_mse_grad_step_2d)

    mesh, fB, u_data, k_true = invert_workload(2, n, batch)
    t0 = time.perf_counter()
    kappa, info = fit_kappa(mesh, fB, u_data, steps=steps)
    jax.block_until_ready(kappa)
    log(f"2D rectangle({n},{n}) B={batch} steps={steps}: "
        f"{time.perf_counter() - t0:.2f} s incl. compile")
    _falls("2D", info, log)
    assert info["path"] == fit_route(2, jax.default_backend())
    assert kappa.shape == (batch, mesh.n_elements)

    kp = 0.5 * (1.0 + k_true)                # off the truth: a real gradient
    refs = _structured_parity(mesh, kp, fB, u_data, parity, maxiter, log,
                              "2D")
    grid = mesh.grid
    H, W = grid.node_shape
    S = parity
    step = jax.jit(lambda klu, f, ud: kappa_mse_grad_step_2d(
        grid, klu, f, mesh.bc_values.reshape(H, W), ud, maxiter,
        scale=1.0))
    klu = kappa_lu_from_elements(grid, kp[:S])
    _, (gl, gu) = step(klu, fB[:S].reshape(S, H, W),
                       u_data[:S].reshape(S, H, W))
    g = jnp.stack([gl, gu], axis=-1).reshape(S, mesh.n_elements)
    check("2D fit-route grad step vs f64", rel_err(g, [r[1] for r in refs]),
          1e-3, log)
    klu_b = kappa_lu_from_elements(grid, kappa)
    step32 = jax.jit(lambda klu, f, ud: kappa_mse_grad_step_2d(
        grid, klu, f, mesh.bc_values.reshape(H, W), ud, info["iters"],
        scale=2.0 / (H * W)))
    memory_line("2D grad step", step32, klu_b, fB.reshape(-1, H, W),
                u_data.reshape(-1, H, W), log=log)
    peak_line(log)
    return info


def phase_2d_batched(n: int, batch: int, iters: int = 128,
                     parity_iters: int = 1024, log=print):
    """Batched fixed-trip facade solves, Dirichlet and Neumann."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from difffe_tpu.mesh import FEMesh
    from difffe_tpu.ops.neumann import boundary_edges, edge_flux_load
    from difffe_tpu.solver import solve_poisson, solve_poisson_batched

    full = FEMesh.rectangle(n, n, dtype=jnp.float32)
    on_left = np.isclose(np.asarray(full.nodes[:, 0]), 0.0)
    neu = dataclasses.replace(
        full, bc_mask=jnp.asarray(on_left, jnp.float32),
        bc_values=jnp.zeros(full.n_nodes, jnp.float32))
    right = boundary_edges(neu, predicate=lambda p: abs(p[0] - 1.0) < 1e-9)
    rng = np.random.default_rng(1)
    kB = jnp.asarray(rng.uniform(0.8, 1.5, (batch, full.n_elements)),
                     jnp.float32)
    fB = jnp.asarray(rng.normal(size=(batch, full.n_nodes)), jnp.float32)
    qB = edge_flux_load(neu, right, jnp.asarray(
        rng.normal(size=(batch, full.n_nodes)), jnp.float32))
    for name, mesh, kw in (("dirichlet", full, {}),
                           ("neumann", neu, {"neumann": qB})):
        solve = jax.jit(lambda k, f, **kw_: solve_poisson_batched(
            mesh, k, f, cg_tol=0.0, cg_maxiter=iters, **kw_))
        t0 = time.perf_counter()
        u = jax.block_until_ready(solve(kB, fB, **kw))
        log(f"2D batched fixed-trip {name} rectangle({n},{n}) B={batch} "
            f"{iters} it: {time.perf_counter() - t0:.2f} s incl. compile")
        assert u.shape == (batch, full.n_nodes)
        assert bool(jnp.all(jnp.isfinite(u)))
        one = {k: v[0] for k, v in kw.items()}
        u0 = solve_poisson(mesh, kB[0], fB[0], cg_tol=0.0,
                           cg_maxiter=iters, **one)
        check(f"2D batched {name} vs one-scenario solve", rel_err(u[0], u0),
              1e-5, log)
        memory_line(f"2D batched {name} solve", solve, kB, fB, **kw,
                    log=log)
    u2 = solve_poisson_batched(neu, kB[:2], fB[:2], cg_tol=0.0,
                               cg_maxiter=parity_iters, neumann=qB[:2])
    ref = [_ref_u(neu, kB[b], fB[b], qB[b]) for b in range(2)]
    check("2D neumann u vs f64 (converged)", rel_err(u2, ref), 1e-4, log)
    peak_line(log)


def _ref_u(mesh, kappa, f, extra_load):
    u, _ = ref_solve_grad(mesh.nodes, mesh.elements, mesh.bc_mask,
                          mesh.bc_values, kappa, f,
                          np.zeros(mesh.n_nodes), extra_load=extra_load)
    return u


def phase_3d(n: int, batch: int, steps: int = 8, parity: int = 2,
             maxiter: int = 512, log=print):
    """fit_kappa on FEMesh.box(n, n, n) × batch, default iterations."""
    import jax

    from difffe_tpu.cli import invert_workload
    from difffe_tpu.inverse import fit_kappa, fit_route
    from difffe_tpu.ops.stencil3d import kappa_mse_grad_step_3d

    mesh, fB, u_data, k_true = invert_workload(3, n, batch)
    t0 = time.perf_counter()
    kappa, info = fit_kappa(mesh, fB, u_data, steps=steps)
    jax.block_until_ready(kappa)
    log(f"3D box({n},{n},{n}) B={batch} steps={steps}: "
        f"{time.perf_counter() - t0:.2f} s incl. compile")
    _falls("3D", info, log)
    assert info["path"] == fit_route(3, jax.default_backend())

    kp = 0.5 * (1.0 + k_true)
    refs = _structured_parity(mesh, kp, fB, u_data, parity, maxiter, log,
                              "3D")
    grid = mesh.grid
    shp = grid.node_shape
    S = parity
    g0 = mesh.bc_values.reshape(shp)
    step = jax.jit(lambda k, f, ud, it: kappa_mse_grad_step_3d(
        grid, k, f, g0, ud, it), static_argnums=3)
    _, g = step(kp[:S], fB[:S].reshape((S,) + shp),
                u_data[:S].reshape((S,) + shp), maxiter)
    numel = S * mesh.n_nodes                  # step's loss is a mean
    check("3D fit-route grad step vs f64",
          rel_err(np.asarray(g) * numel / 2.0, [r[1] for r in refs]), 1e-3,
          log)
    memory_line("3D grad step", step, kappa, fB.reshape((-1,) + shp),
                u_data.reshape((-1,) + shp), info["iters"], log=log)
    peak_line(log)
    return info


def phase_unstructured(n: int, batch: int, steps: int = 32,
                       parity: int = 2, maxiter: int = 1024, log=print):
    """The ``cli invert --dim 2 --unstructured`` workload."""
    import jax

    from difffe_tpu.cli import invert_workload
    from difffe_tpu.inverse import fit_kappa

    mesh, fB, u_data, k_true = invert_workload(2, n, batch,
                                               unstructured=True)
    t0 = time.perf_counter()
    kappa, info = fit_kappa(mesh, fB, u_data, steps=steps)
    jax.block_until_ready(kappa)
    log(f"unstructured 2D n={n} B={batch} steps={steps}: "
        f"{time.perf_counter() - t0:.2f} s incl. compile")
    _falls("unstructured", info, log)
    expect = "generic_ell_batchminor" if batch >= 128 else "generic_adam"
    assert info["path"] == expect, info["path"]

    S = parity
    kp = 0.5 * (1.0 + k_true[:S])
    u_err, g_err, vg = unstructured_parity(mesh, kp, fB[:S], u_data[:S],
                                           maxiter)
    check(f"unstructured u vs f64 (f32 ELL CG, {maxiter} it)", u_err, 1e-4,
          log)
    check("unstructured grad vs f64 (f32 ELL CG adjoint)", g_err, 1e-3, log)
    memory_line("unstructured ELL grad step", vg, kp, log=log)
    peak_line(log)
    return info


def unstructured_parity(mesh, kappa, fB, u_data, maxiter: int):
    """Edge-ELL batched solve and its adjoint κ-gradient vs the scipy
    f64 reference: (u rel err, grad rel err, the jitted value_and_grad)."""
    import jax
    import jax.numpy as jnp

    from difffe_tpu.ops.assembly import assemble_load
    from difffe_tpu.ops.unstructured import (build_ell,
                                             solve_poisson_cg_ell_batched)

    ell = build_ell(mesh)
    FB = assemble_load(mesh, fB)

    def loss(k):
        u = solve_poisson_cg_ell_batched(mesh, ell, k, FB, 0.0, maxiter)
        return 0.5 * jnp.sum((u - u_data) ** 2), u

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    with jax.default_matmul_precision("highest"):
        (_, u), g = vg(kappa)
    refs = [ref_solve_grad(mesh.nodes, mesh.elements, mesh.bc_mask,
                           mesh.bc_values, kappa[b], fB[b], u_data[b])
            for b in range(len(kappa))]
    return (rel_err(u, [r[0] for r in refs]),
            rel_err(g, [r[1] for r in refs]), vg)


def phase_multi(n_dev: int = 4, n2d: int = 64, batch: int = 256,
                n3d: int = 16, log=print):
    """Sharded paths on a dp × dof mesh vs the same computation on one
    device: make_inversion_step at a config-4 shape, and the 2D and 3D
    halo solvers forward + κ-gradient.  Everything runs in float64, so a
    check sees the partitioning (collectives, halo exchange, psum'd dots)
    and not float32 CG rounding."""
    import jax

    from difffe_tpu.parallel import make_device_mesh

    devs = jax.devices()[:n_dev]
    assert len(devs) == n_dev, f"--multi needs {n_dev} devices"
    dof = 2
    dp = n_dev // dof
    dmesh = make_device_mesh(devices=devs, mesh_shape=(dp, dof))
    one = make_device_mesh(devices=devs[:1], mesh_shape=(1, 1))
    log(f"multi: dp={dp} x dof={dof} on {[d.id for d in devs]}")
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        _inversion_parity(dmesh, one, n2d, batch, log)
        _halo_parity(dmesh, dp, n2d, n3d, log)
    finally:
        jax.config.update("jax_enable_x64", x64)


def inversion_workload(n2d: int, batch: int, dtype):
    """Config-4 κ-field inversion: rectangle(n2d, n2d − 1), so the node
    count (n2d + 1)·n2d splits over the dof axis, a random per-element κ
    field per scenario, one shared forcing, converged observations."""
    import jax.numpy as jnp

    from difffe_tpu.mesh import FEMesh
    from difffe_tpu.solver import solve_poisson_batched

    fe = FEMesh.rectangle(n2d, n2d - 1, dtype=dtype)
    f = jnp.prod(jnp.sin(jnp.pi * fe.nodes), axis=1) * 10.0
    fB = jnp.broadcast_to(f, (batch, fe.n_nodes))
    rng = np.random.default_rng(4)
    k_true = jnp.asarray(rng.uniform(0.5, 2.0, (batch, fe.n_elements)),
                         dtype)
    ud = solve_poisson_batched(fe, k_true, fB, kappa_batched=True)
    return fe, fB, ud


def inversion_run(fe, fB, ud, dmesh, shard_dof: bool):
    """make_inversion_step on ``dmesh`` from log κ = 0 (B, n_elements):
    the loss gradient (one ``optax.sgd(1.0)`` step's update, negated),
    the loss at κ₀, and log κ after two Adam steps."""
    import jax
    import jax.numpy as jnp
    import optax

    from difffe_tpu.parallel import make_inversion_step

    lk0 = jnp.zeros(fB.shape[:1] + (fe.n_elements,), fB.dtype)
    out = []
    for opt in (optax.sgd(1.0), optax.adam(0.05)):
        init_fn, step_fn, data_sh = make_inversion_step(
            fe, dmesh, shard_dof=shard_dof, optimizer=opt)
        f_s, u_s = jax.device_put(fB, data_sh), jax.device_put(ud, data_sh)
        lk, st = init_fn(lk0)
        lk1, st, loss0 = step_fn(lk, st, f_s, u_s)
        out.append((lk1, loss0, step_fn(lk1, st, f_s, u_s)[0]))
    (lk_sgd, loss0, _), (_, _, lk_adam2) = out
    return (-np.asarray(lk_sgd), float(loss0), np.asarray(lk_adam2))


def _inversion_parity(dmesh, one, n2d, batch, log):
    """make_inversion_step sharded over dp × dof vs one device (f64)."""
    import jax.numpy as jnp

    fe, fB, ud = inversion_workload(n2d, batch, jnp.float64)
    res = {}
    for name, dm, dof_sh in (("sharded", dmesh, True), ("one", one, False)):
        t0 = time.perf_counter()
        res[name] = inversion_run(fe, fB, ud, dm, dof_sh)
        log(f"  inversion step {name} (f64, κ-field {batch} x "
            f"{fe.n_elements}): {time.perf_counter() - t0:.2f} s incl. "
            f"compile, loss at κ0 {res[name][1]:.9e}")
    for i, what in ((0, "loss gradient"), (1, "loss at κ0"),
                    (2, "log κ after two Adam steps")):
        check(f"multi inversion {what} sharded vs one device (f64)",
              rel_err(res["sharded"][i], res["one"][i]), 1e-5, log)


def _halo_parity(dmesh, dp, n2d, n3d, log):
    """2D and 3D halo solvers, forward + κ-gradient, vs one device."""
    import jax
    import jax.numpy as jnp

    from difffe_tpu.ops.stencil import StructuredGrid, solve_poisson_structured
    from difffe_tpu.ops.stencil3d import (StructuredGrid3,
                                          solve_poisson_structured_3d)
    from difffe_tpu.parallel.halo import make_halo_solver
    from difffe_tpu.parallel.halo3d import make_halo_solver_3d

    f64 = jnp.float64
    res = {}

    # (2) 2D halo solver: node rows (ny+1) divisible by dof
    grid = StructuredGrid.unit(n2d, n2d - 1)
    H, W = grid.node_shape
    Bh = 2 * dp
    rng = np.random.default_rng(3)
    kl = jnp.asarray(rng.uniform(0.8, 1.5, (Bh, grid.ny, grid.nx)),
                     f64)
    ku = jnp.asarray(rng.uniform(0.8, 1.5, (Bh, grid.ny, grid.nx)),
                     f64)
    fh = jnp.asarray(rng.normal(size=(Bh, H, W)), f64)
    gh = jnp.zeros((H, W), f64)
    uh_t = jnp.asarray(rng.normal(size=(Bh, H, W)), f64) * 0.01
    it2 = 512
    halo = make_halo_solver(dmesh, grid, maxiter=it2, batch_axis="dp")

    def ref2(klu, f, g):
        return jax.vmap(lambda a, b, c: solve_poisson_structured(
            grid, (a, b), c, g, 0.0, it2))(*klu, f)

    for label, solver in (("halo", halo), ("one", ref2)):
        def loss(k, solver=solver):
            u = solver((k, ku), fh, gh)
            return jnp.sum((u - uh_t) ** 2), u
        (_, u), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(kl)
        res[label] = (np.asarray(u), np.asarray(g))
    check("multi 2D halo u vs one device (f64)",
          rel_err(res["halo"][0], res["one"][0]), 1e-5, log)
    check("multi 2D halo grad vs one device (f64)",
          rel_err(res["halo"][1], res["one"][1]), 1e-5, log)

    # (3) 3D halo solver: z-planes (nz+1) divisible by dof
    g3 = StructuredGrid3.unit(n3d, n3d, n3d - 1)
    shp = g3.node_shape
    k3 = jnp.asarray(rng.uniform(0.8, 1.5, (Bh, g3.n_elements)), f64)
    f3 = jnp.asarray(rng.normal(size=(Bh,) + shp), f64)
    g30 = jnp.zeros(shp, f64)
    u3_t = jnp.asarray(rng.normal(size=(Bh,) + shp), f64) * 0.01
    it3 = 256
    halo3 = make_halo_solver_3d(dmesh, g3, maxiter=it3, batch_axis="dp")

    def ref3(k, f, g):
        return jax.vmap(lambda a, c: solve_poisson_structured_3d(
            g3, a, c, g, 0.0, it3))(k, f)

    for label, solver in (("halo3", halo3), ("one3", ref3)):
        def loss3(k, solver=solver):
            u = solver(k, f3, g30)
            return jnp.sum((u - u3_t) ** 2), u
        (_, u), g = jax.jit(jax.value_and_grad(loss3, has_aux=True))(k3)
        res[label] = (np.asarray(u), np.asarray(g))
    check("multi 3D halo u vs one device (f64)",
          rel_err(res["halo3"][0], res["one3"][0]), 1e-5, log)
    check("multi 3D halo grad vs one device (f64)",
          rel_err(res["halo3"][1], res["one3"][1]), 1e-5, log)


# ---------------------------------------------------------------------------

def card_line() -> str:
    """``nvidia-smi`` name and power limit, read by a child without JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    from difffe_tpu.utils.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    print(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)} jax={jax.__version__} compile_cache={cache}")
    print(f"card: {card_line()}", flush=True)
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(n_dev=4)
    else:
        phase_1d(30, 2_097_152, steps=64)
        phase_1d(128, 1024, steps=64)
        phase_2d(64, 256, steps=32)
        phase_2d_batched(64, 256)
        phase_3d(32, 128, steps=8)
        phase_unstructured(64, 128, steps=32)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
