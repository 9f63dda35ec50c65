"""Pallas-Triton kernel: k closed-form SGD steps of 1D per-element-κ
inversion per launch.

The chain factorization (ops/cf1d.py) collapses the per-element-κ
tridiagonal solve to two prefix sums and a rank-1 correction.  Indexed
by element e (element e joins nodes e and e+1):

    s = h_e/κ_e;  S = cumsum(s);  T = cumsum(s·P)         (P from F)
    w₁ = (u_R − u_L + T_tot)/S_tot;   u_{e+1} = u_L + w₁S_e − T_e
    adjoint: r_e = scale·(u_{e+1} − u_data_{e+1}) on interior nodes,
             Pλ = exclusive cumsum(r),  w₁λ = Σ s·Pλ / S_tot
    ∂κ_e = −(h_e/κ_e²)·(w₁ − P_e)·(w₁λ − Pλ_e)              (elementwise)

Every quantity sits at the element index, so the node shift of the
solution becomes the exclusive prefix sum (inclusive minus summand) and
the kernel needs only forward ``jnp.cumsum`` along the element axis.

Layout: κ and the shifted observations are (B, N) row-major planes,
one scenario per row, elements padded to a power of two N.  A block of
rows holds every scenario's whole state, so ``n_inner`` SGD steps run
with κ in registers and a launch moves κ in, u_data in and κ out once —
the XLA form (one ``kappa_mse_step_cf`` per ``lax.scan`` iteration)
moves the same bytes on every step.

Padding contract: element columns ≥ n_elements carry h_e = 0 → s = 0,
so prefix totals are unaffected and their gradient is exactly 0; they
and padded rows carry κ = 1 and are sliced off by ``cf_unpack``.

Scope: Dirichlet at exactly the two chain ends with shared values, and
a shared assembled load F.  Batched F falls back to the XLA closed form
(ops/cf1d.py), arbitrary Dirichlet masks to the tridiagonal path.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

#: most elements one block holds (rows × padded element columns)
_BLOCK_ELEMS = 2048
#: rows per block are at most B/512, so any batch of ≥ 512 scenarios
#: spreads over ≥ 512 blocks (the card has 132 SMs)
_MIN_BLOCKS = 512


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _launch_config(N: int, B: int):
    """(rows per block, warps) for B scenarios of N padded elements.

    From ``scripts/tune_cf_chain.py --sweep`` on an H100 80GB HBM3 with
    a 700 W power limit (docs/PERFORMANCE.md), SGD loop alone: at
    30 elements × 2M scenarios, blocks of 512 to 4,096 elements with
    this rule's warp count (one warp per 128 elements, at most 8) all
    run within 3% of the sweep's best, while 4,096-element blocks with
    2 warps run 56% slower; at 128 elements × 1024 scenarios its 2-row,
    2-warp blocks run within 9% of the best and 1.95× faster than
    32-row, 8-warp blocks.  At 16,384 elements an 8-warp row spills
    registers and loses to XLA, so ``fit_route`` keeps chains longer
    than ``inverse.CHAIN_MAX_ELEMENTS`` on the XLA closed form."""
    rows = 1 << max(B // _MIN_BLOCKS, 1).bit_length() - 1
    rows = max(1, min(_BLOCK_ELEMS // N, rows))
    return rows, max(1, min(8, rows * N // 128))


def _chain_kernel(ke_ref, ud_ref, hs_ref, pf_ref, dm_ref, rm_ref,
                  loss_ref, ke_out_ref, *, n_inner: int, lr: float,
                  scale: float, u_l: float, du: float):
    hs = hs_ref[...]          # (1, N) element widths, 0 on pads
    pf = pf_ref[...]          # (1, N) P_e = Σ_{1≤j≤e} F_j
    dm = dm_ref[...]          # (1, N) 1 where node e+1 exists
    rm = rm_ref[...]          # (1, N) 1 where node e+1 is interior
    ud = ud_ref[...]          # (rows, N) u_data at node e+1

    def step(_, carry):
        ke, _ = carry
        inv = 1.0 / ke
        s = hs * inv
        sp = s * pf
        s_tot = jnp.sum(s, axis=1, keepdims=True)
        w1 = (du + jnp.sum(sp, axis=1, keepdims=True)) / s_tot
        u = u_l + w1 * jnp.cumsum(s, axis=1) - jnp.cumsum(sp, axis=1)
        d = (u - ud) * dm
        r = scale * d * rm
        plam = jnp.cumsum(r, axis=1) - r
        wl1 = jnp.sum(s * plam, axis=1, keepdims=True) / s_tot
        g = -(hs * inv * inv) * (w1 - pf) * (wl1 - plam)
        return ke - lr * g, jnp.sum(d * d, axis=1)

    ke = ke_ref[...]
    ke, loss = jax.lax.fori_loop(
        0, n_inner, step, (ke, jnp.zeros(ke.shape[:1], ke.dtype)))
    loss_ref[...] = loss
    ke_out_ref[...] = ke


@functools.partial(jax.jit, static_argnames=(
    "n_inner", "lr", "scale", "u_l", "du", "interpret", "rows",
    "num_warps"))
def _chain_call(keP, udP, consts, *, n_inner: int, lr: float, scale: float,
                u_l: float, du: float, interpret: bool, rows: int,
                num_warps: int):
    Bp, N = keP.shape
    kernel = functools.partial(_chain_kernel, n_inner=n_inner, lr=lr,
                               scale=scale, u_l=u_l, du=du)
    plane = pl.BlockSpec((rows, N), lambda i: (i, 0))
    # consts rows: element widths, P_e, node mask, interior-node mask
    row = [pl.BlockSpec((1, N), lambda i, k=k: (k, 0)) for k in range(4)]
    return pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((Bp,), keP.dtype),
                   jax.ShapeDtypeStruct((Bp, N), keP.dtype)),
        grid=(Bp // rows,),
        in_specs=[plane, plane, *row],
        out_specs=(pl.BlockSpec((rows,), lambda i: (i,)), plane),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        name="cf_sgd_chain",
    )(keP, udP, consts, consts, consts, consts)


def _check_supported(mesh, F):
    from ..cf1d import mesh_supports_cf

    if not mesh_supports_cf(mesh):
        raise ValueError(
            "closed-form kernel needs Dirichlet at exactly the two "
            "endpoint nodes (FEMesh.line factory meshes) — use the "
            "tridiagonal path for general Dirichlet masks")
    if jnp.asarray(F).ndim != 1:
        raise ValueError(
            "closed-form kernel needs a shared (unbatched) load F — "
            "use ops.cf1d.kappa_mse_step_cf for per-scenario loads")


_static = dict(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CFOperands:
    """Everything but κ that the chain kernel reads: the shifted
    observation plane, the element constants, and (static) the sizes,
    boundary values and launch shape.  A pytree, so it passes through
    ``jax.jit``."""

    udP: jax.Array            # (Bp, N) u_data at node e+1
    consts: jax.Array         # (4, N) h_e, P_e, node mask, interior mask
    ud0: jax.Array            # (B,) u_data at node 0
    B: int = dataclasses.field(**_static)
    ne: int = dataclasses.field(**_static)
    n: int = dataclasses.field(**_static)
    u_l: float = dataclasses.field(**_static)
    u_r: float = dataclasses.field(**_static)
    rows: int = dataclasses.field(**_static)
    num_warps: int = dataclasses.field(**_static)


@functools.lru_cache(maxsize=64)
def _packer(B: int, Bp: int, N: int, hs: tuple):
    """One jitted call that pads κ and u_data into (Bp, N) planes and
    builds the constants from the assembled load."""
    ne = len(hs)
    fixed = np.zeros((4, N))
    fixed[0, :ne] = hs
    fixed[2, :ne] = 1.0
    fixed[3, :ne - 1] = 1.0

    @jax.jit
    def pack(kappa_e, F, u_data):
        dtype = kappa_e.dtype
        pf = jnp.zeros((N,), dtype).at[1:ne].set(jnp.cumsum(F[1:ne]))
        consts = jnp.asarray(fixed, dtype).at[1].set(pf)
        keP = jnp.pad(kappa_e, ((0, Bp - B), (0, N - ne)),
                      constant_values=1.0)
        udP = jnp.pad(u_data[:, 1:], ((0, Bp - B), (0, N - ne)))
        return keP, udP, consts, u_data[:, 0]

    return pack


def cf_packed_operands(mesh, kappa_e: jax.Array, F: jax.Array,
                       u_data: jax.Array):
    """Pack κ (B, n_elements) and u_data (B, n_nodes) or shared (n_nodes,)
    into the kernel's (Bp, N) planes; F is the shared assembled load.

    Returns (keP, ops): thread ``keP`` through the optimizer loop with
    :func:`kappa_sgd_chain_cf` and unpack once at the end with
    :func:`cf_unpack`."""
    from ..cf1d import _element_widths

    _check_supported(mesh, F)
    dtype = mesh.dtype
    kappa_e = jnp.asarray(kappa_e, dtype)
    B, ne = kappa_e.shape
    n = mesh.n_nodes
    N = max(16, _next_pow2(ne))
    rows, num_warps = _launch_config(N, B)
    Bp = -(-B // rows) * rows
    pack = _packer(B, Bp, N, tuple(_element_widths(mesh).tolist()))
    keP, udP, consts, ud0 = pack(
        kappa_e, jnp.asarray(F, dtype),
        jnp.broadcast_to(jnp.asarray(u_data, dtype), (B, n)))
    bc = np.asarray(mesh.bc_values, np.float64)
    return keP, CFOperands(udP=udP, consts=consts, ud0=ud0, B=B, ne=ne,
                           n=n, u_l=float(bc[0]), u_r=float(bc[-1]),
                           rows=rows, num_warps=num_warps)


def cf_unpack(keP: jax.Array, ops: CFOperands) -> jax.Array:
    return keP[:ops.B, :ops.ne]


def kappa_sgd_chain_cf(keP: jax.Array, ops: CFOperands, n_inner: int,
                       lr: float, scale: float | None = None,
                       interpret: bool = False):
    """``n_inner`` SGD steps κ ← κ − lr·∂κ in one kernel launch.

    Returns (loss_parts (B,) of the LAST inner step's κ, keP'), where
    loss_parts[b] = Σ_i (u_b − u_data_b)_i² and the gradient is that of
    scale/2 · Σ_b loss_parts (``scale`` defaults to 2/(B·n)).  Equals
    ``n_inner`` steps of ``ops.cf1d.kappa_mse_step_cf`` to f32 rounding.
    ``interpret=True`` runs the kernel body on the host (tests)."""
    if int(n_inner) < 1:
        raise ValueError("kappa_sgd_chain_cf needs n_inner >= 1")
    if scale is None:
        scale = 2.0 / (ops.B * ops.n)
    lp, keP = _chain_call(
        keP, ops.udP, ops.consts, n_inner=int(n_inner), lr=float(lr),
        scale=float(scale), u_l=ops.u_l, du=ops.u_r - ops.u_l,
        interpret=bool(interpret), rows=ops.rows,
        num_warps=ops.num_warps)
    return lp[:ops.B] + (ops.u_l - ops.ud0) ** 2, keP
