"""Topology optimization: SIMP compliance minimization on structured meshes.

North-star config 5 capability ('2D topology-optimization (compliance min)').
Thermal-compliance formulation on the rectangle mesh: distribute material
density ρ ∈ [0,1] per quad to minimize C(ρ) = FᵀU with K(κ(ρ))U = F under a
volume constraint mean(ρ) = v̄.

Structure:
  * densities live on the (ny, nx) quad grid; both triangles of a quad share
    one density (mesh.rectangle emits them interleaved, mesh.py factories);
  * SIMP interpolation κ = κ_min + ρᵖ(κ₀ − κ_min);
  * density filter = 2D convolution with a normalized cone kernel
    (``lax.conv_general_dilated`` — a dense stencil op, instead of
    the sparse neighbor matrices CPU codes build);
  * sensitivities dC/dρ via the solver's custom-VJP adjoint (one extra
    solve), NOT an autograd tape over assembly;
  * optimality-criteria update with a ``lax.while_loop`` bisection on the
    Lagrange multiplier — fully jittable, so the whole optimization loop
    stays on-device; scenario batches via ``jax.vmap``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..mesh import FEMesh
from ..ops.assembly import assemble_load
from ..solver import solve_poisson


@dataclasses.dataclass(frozen=True)
class TopOptConfig:
    nx: int = 32
    ny: int = 32
    vol_frac: float = 0.4
    penal: float = 3.0           # SIMP exponent p
    kappa_min: float = 1e-3
    kappa0: float = 1.0
    filter_radius: float = 1.5   # in units of quad size
    move: float = 0.2            # OC move limit
    n_iters: int = 50
    method: str = "auto"         # solver method for the state solves
    cg_maxiter: Optional[int] = None


def cone_filter_kernel(radius: float, dtype) -> jax.Array:
    """Normalized cone (linear hat) kernel of the given radius in quads."""
    r = int(jnp.floor(radius))
    size = 2 * r + 1
    ij = jnp.arange(-r, r + 1, dtype=dtype)
    dist = jnp.sqrt(ij[:, None] ** 2 + ij[None, :] ** 2)
    w = jnp.maximum(0.0, radius - dist)
    return w / jnp.sum(w)


def density_filter(rho_grid: jax.Array, kernel: jax.Array) -> jax.Array:
    """Filter densities on the (ny, nx) grid (edge-renormalized conv)."""
    dtype = rho_grid.dtype
    x = rho_grid[None, None]                     # NCHW
    k = kernel[None, None]
    pad = (kernel.shape[0] // 2, kernel.shape[1] // 2)
    conv = partial(jax.lax.conv_general_dilated,
                   window_strides=(1, 1),
                   padding=[(pad[0], pad[0]), (pad[1], pad[1])])
    num = conv(x, k)
    den = conv(jnp.ones_like(x), k)
    return (num / den)[0, 0].astype(dtype)


def simp_kappa(rho_tri: jax.Array, cfg: TopOptConfig) -> jax.Array:
    return cfg.kappa_min + (rho_tri ** cfg.penal) * (cfg.kappa0 - cfg.kappa_min)


def quads_to_tris(rho_grid: jax.Array) -> jax.Array:
    """(ny, nx) quad densities → (2·ny·nx,) per-triangle κ multiplier, in
    the interleaved [lower_0, upper_0, lower_1, ...] element order emitted by
    ``FEMesh.rectangle``."""
    flat = rho_grid.reshape(-1)
    return jnp.repeat(flat, 2)


def compliance(mesh: FEMesh, rho_grid: jax.Array, f: jax.Array,
               cfg: TopOptConfig, kernel: jax.Array) -> jax.Array:
    """C(ρ) = FᵀU after filtering + SIMP; differentiable via solver adjoint."""
    rho_f = density_filter(rho_grid, kernel)
    kappa_e = simp_kappa(quads_to_tris(rho_f), cfg)
    u = solve_poisson(mesh, kappa_e, f, method=cfg.method,
                      cg_maxiter=cfg.cg_maxiter)
    F = assemble_load(mesh, f)
    return jnp.sum(F * u)


def oc_update(rho: jax.Array, dc: jax.Array, cfg: TopOptConfig) -> jax.Array:
    """Optimality-criteria step with bisection on the volume multiplier.

    dc ≤ 0 in well-posed compliance problems; clipped for robustness.
    """
    dc_neg = jnp.minimum(dc, -1e-12)
    lo = jnp.asarray(1e-9, rho.dtype)
    hi = jnp.asarray(1e9, rho.dtype)

    def candidate(lam):
        scale = jnp.sqrt(-dc_neg / lam)
        r = rho * scale
        r = jnp.clip(r, rho - cfg.move, rho + cfg.move)
        return jnp.clip(r, 0.0, 1.0)

    def cond(state):
        lo, hi = state
        return (hi - lo) / (hi + lo) > 1e-6

    def body(state):
        lo, hi = state
        mid = jnp.sqrt(lo * hi)              # geometric bisection
        too_much = jnp.mean(candidate(mid)) > cfg.vol_frac
        # more material than allowed → raise λ
        return jnp.where(too_much, mid, lo), jnp.where(too_much, hi, mid)

    lo, hi = jax.lax.while_loop(cond, body, (lo, hi))
    return candidate(jnp.sqrt(lo * hi))


def optimize(
    mesh: FEMesh,
    f: jax.Array,
    cfg: TopOptConfig,
    rho0: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Run cfg.n_iters OC iterations; returns (ρ grid, compliance history).

    The whole loop is one jitted ``lax.scan``: each iteration = state solve +
    adjoint solve + filter chain VJP + OC bisection.
    """
    if rho0 is None:
        rho0 = jnp.full((cfg.ny, cfg.nx), cfg.vol_frac, dtype=mesh.dtype)
    kernel = cone_filter_kernel(cfg.filter_radius, mesh.dtype)

    comp = lambda r: compliance(mesh, r, f, cfg, kernel)

    @jax.jit
    def run(rho):
        def step(rho, _):
            c, dc = jax.value_and_grad(comp)(rho)
            rho = oc_update(rho, dc, cfg)
            return rho, c

        return jax.lax.scan(step, rho, None, length=cfg.n_iters)

    return run(rho0)


def optimize_batched(mesh: FEMesh, f_batch: jax.Array, cfg: TopOptConfig,
                     rho0: Optional[jax.Array] = None):
    """Scenario-batched topology optimization: f_batch (B, n_nodes) →
    (ρ (B, ny, nx), compliance histories (B, n_iters))."""
    fn = lambda f: optimize(mesh, f, cfg, rho0)
    rhos, hists = jax.vmap(fn)(f_batch)
    return rhos, hists
