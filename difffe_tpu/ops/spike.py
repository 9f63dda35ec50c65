"""SPIKE (partitioned) tridiagonal solver for large 1D systems.

PCR (ops/tridiag.py) is depth-O(log n) but work-O(n log n) — at n ≳ 512 the
extra sweeps dominate.  SPIKE partitions each system into C chunks of
length L = n/C:

1. per-chunk Thomas solves (sequential depth L, fully vectorized over
   batch × chunks × 3 right-hand sides: F, and the two coupling columns);
2. a reduced 2C×2C pentadiagonal interface system (batched dense solve —
   tiny);
3. a rank-2 reconstruction per chunk.

Total work O(n) with depth L + O(1): choose L ≈ 32-64 so the scans stay
short while the reduced system stays small.  Same symmetric custom-VJP
adjoint as the other band solvers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _thomas_multi(dl, d, du, rhs):
    """Vectorized Thomas for many independent tridiagonal systems.

    dl, d, du: (..., L) sub/main/super diagonals (dl[...,0] and du[...,-1]
    ignored); rhs: (..., L, K) multiple right-hand sides.
    Sequential only in L (two lax.scans); everything else vectorized.
    """
    L = d.shape[-1]

    # forward elimination: w_i = dl_i / dhat_{i-1};
    # dhat_i = d_i - w_i * du_{i-1}; rhat_i = r_i - w_i * rhat_{i-1}
    def fwd(carry, inp):
        dprev, rprev = carry
        di, dli, dui_prev, ri = inp
        w = dli / dprev
        dhat = di - w * dui_prev
        rhat = ri - w[..., None] * rprev
        return (dhat, rhat), (dhat, rhat)

    d_t = jnp.moveaxis(d, -1, 0)          # (L, ...)
    dl_t = jnp.moveaxis(dl, -1, 0)
    du_t = jnp.moveaxis(du, -1, 0)
    r_t = jnp.moveaxis(rhs, -2, 0)        # (L, ..., K)

    # first row: no elimination
    (_, _), (dhat_t, rhat_t) = jax.lax.scan(
        fwd, (d_t[0], r_t[0]),
        (d_t[1:], dl_t[1:], du_t[:-1], r_t[1:]))
    dhat_t = jnp.concatenate([d_t[:1], dhat_t], axis=0)
    rhat_t = jnp.concatenate([r_t[:1], rhat_t], axis=0)

    # back substitution: x_i = (rhat_i - du_i x_{i+1}) / dhat_i
    def bwd(x_next, inp):
        dhat_i, du_i, rhat_i = inp
        x = (rhat_i - du_i[..., None] * x_next) / dhat_i[..., None]
        return x, x

    x_last = rhat_t[-1] / dhat_t[-1][..., None]
    _, xs = jax.lax.scan(bwd, x_last,
                         (dhat_t[:-1], du_t[:-1], rhat_t[:-1]),
                         reverse=True)
    x_t = jnp.concatenate([xs, x_last[None]], axis=0)
    return jnp.moveaxis(x_t, 0, -2)       # (..., L, K)


def _solve_reduced(M, rhs):
    """Batched solve of the small reduced system (≈ I + small couplings,
    well-conditioned) by LU in the input precision."""
    return jnp.linalg.solve(M, rhs[..., None])[..., 0]


def _spike_impl(d, e, F, chunk):
    """d: (B, n), e: (B, n-1), F: (B, n); n % chunk == 0."""
    B, n = d.shape
    L = chunk
    C = n // L

    # chunk-local bands
    dc = d.reshape(B, C, L)
    # global sub/super diagonal split into intra-chunk and coupling parts
    e_full = jnp.concatenate([e, jnp.zeros((B, 1), d.dtype)], axis=-1)
    ec = e_full.reshape(B, C, L)          # ec[..., :L-1] intra; ec[..., L-1] couples to next chunk
    intra = ec[..., :L - 1]
    couple = ec[..., L - 1]               # (B, C): chunk i ↔ chunk i+1 (last col zero)

    dl = jnp.concatenate([jnp.zeros((B, C, 1), d.dtype), intra], axis=-1)
    du = jnp.concatenate([intra, jnp.zeros((B, C, 1), d.dtype)], axis=-1)

    # 3 RHS per chunk: F, e_first (coupling to prev), e_last (coupling to next)
    bL = jnp.concatenate([jnp.zeros((B, 1), d.dtype), couple[:, :-1]],
                         axis=1)          # (B, C): coupling to the left
    bR = couple                           # (B, C): coupling to the right
    rhs = jnp.zeros((B, C, L, 3), d.dtype)
    rhs = rhs.at[..., 0].set(F.reshape(B, C, L))
    rhs = rhs.at[..., 0, 1].set(1.0)      # unit first-entry column
    rhs = rhs.at[..., L - 1, 2].set(1.0)  # unit last-entry column

    sol = _thomas_multi(dl, dc, du, rhs)  # (B, C, L, 3)
    y = sol[..., 0]                       # A⁻¹ F
    w = sol[..., 1]                       # A⁻¹ e_first
    v = sol[..., 2]                       # A⁻¹ e_last

    # reduced system in z = (t_0, s_0, …, t_{C-1}, s_{C-1}) where
    # t_i = x_i[0], s_i = x_i[L-1]:
    #   t_i + bL_i w_i[0]  s_{i-1} + bR_i v_i[0]  t_{i+1} = y_i[0]
    #   s_i + bL_i w_i[-1] s_{i-1} + bR_i v_i[-1] t_{i+1} = y_i[-1]
    M = jnp.zeros((B, 2 * C, 2 * C), d.dtype)
    idx = jnp.arange(2 * C)
    M = M.at[:, idx, idx].set(1.0)
    ci = jnp.arange(C)
    rows_t, rows_s = 2 * ci, 2 * ci + 1
    # s_{i-1} column = 2(i-1)+1 = 2i-1 (valid for i>=1)
    M = M.at[:, rows_t[1:], 2 * ci[1:] - 1].add(bL[:, 1:] * w[:, 1:, 0])
    M = M.at[:, rows_s[1:], 2 * ci[1:] - 1].add(bL[:, 1:] * w[:, 1:, L - 1])
    # t_{i+1} column = 2(i+1) (valid for i<C-1)
    M = M.at[:, rows_t[:-1], 2 * ci[:-1] + 2].add(bR[:, :-1] * v[:, :-1, 0])
    M = M.at[:, rows_s[:-1], 2 * ci[:-1] + 2].add(
        bR[:, :-1] * v[:, :-1, L - 1])

    rhs_red = jnp.stack([y[..., 0], y[..., L - 1]], axis=-1
                        ).reshape(B, 2 * C)
    z = _solve_reduced(M, rhs_red)                        # (B, 2C)
    s = z.reshape(B, C, 2)[..., 1]        # (B, C) last entries
    t = z.reshape(B, C, 2)[..., 0]        # (B, C) first entries

    s_prev = jnp.concatenate([jnp.zeros((B, 1), d.dtype), s[:, :-1]], axis=1)
    t_next = jnp.concatenate([t[:, 1:], jnp.zeros((B, 1), d.dtype)], axis=1)

    x = (y - (bL * s_prev)[..., None] * w
         - (bR * t_next)[..., None] * v)  # (B, C, L)
    return x.reshape(B, n)


def _pad_to_chunks(d, e, F, chunk):
    """Pad n up to a chunk multiple with decoupled identity rows."""
    B, n = d.shape
    n_pad = (-n) % chunk
    if n_pad == 0:
        return d, e, F, n
    dp = jnp.concatenate([d, jnp.ones((B, n_pad), d.dtype)], axis=-1)
    ep = jnp.concatenate([e, jnp.zeros((B, n_pad), d.dtype)], axis=-1)
    Fp = jnp.concatenate([F, jnp.zeros((B, n_pad), d.dtype)], axis=-1)
    return dp, ep, Fp, n


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def tridiag_solve_spike(d: jax.Array, e: jax.Array, F: jax.Array,
                        chunk: int = 64) -> jax.Array:
    """Solve T u = F (symmetric tridiagonal) by the SPIKE partitioning.

    d: (..., n), e: (..., n-1), F: (..., n); best for n ≳ 512 where PCR's
    O(n log n) work dominates.  Arbitrary leading batch axes.
    """
    return _solve(d, e, F, chunk)


def _solve(d, e, F, chunk):
    lead = d.shape[:-1]
    n = d.shape[-1]
    d2, e2, F2 = (a.reshape(-1, a.shape[-1]) for a in (d, e, F))
    dp, ep, Fp, n_true = _pad_to_chunks(d2, e2, F2, chunk)
    u = _spike_impl(dp, ep, Fp, chunk)[:, :n_true]
    return u.reshape(lead + (n,))


def _fwd(d, e, F, chunk):
    u = _solve(d, e, F, chunk)
    return u, (d, e, u)


def _bwd(chunk, res, g):
    d, e, u = res
    lam = _solve(d, e, g, chunk)          # T symmetric ⇒ Tλ = ḡ
    grad_d = -lam * u
    grad_e = -(lam[..., :-1] * u[..., 1:] + lam[..., 1:] * u[..., :-1])
    return grad_d, grad_e, lam


tridiag_solve_spike.defvjp(_fwd, _bwd)
