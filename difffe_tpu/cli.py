"""Command-line entry point: run any BASELINE scenario end-to-end.

    python -m difffe_tpu.cli list
    python -m difffe_tpu.cli run demo_1d
    python -m difffe_tpu.cli run batched_inverse_1d --batch 2048 --steps 300
    python -m difffe_tpu.cli bench batched_inverse_1d

The reference has no CLI (plain scripts only, SURVEY.md §1); this wraps the
library's functional API with the config system (utils/config.py), metrics
stream (utils/metrics.py), and timing harness (utils/profiling.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp


def _mesh_for(cfg):
    from .mesh import FEMesh
    dtype = jnp.float64 if cfg.dtype == "f64" else jnp.float32
    if cfg.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    if cfg.dim == 1:
        return FEMesh.line(n_elements=cfg.n_elements, dtype=dtype)
    return FEMesh.rectangle(nx=cfg.n_elements, ny=cfg.n_elements, dtype=dtype)


def run_scenario(cfg, log=print):
    """Dispatch one scenario; returns a result dict."""
    from .solver import solve_poisson, solve_poisson_batched
    from .utils.metrics import MetricsLogger
    import optax

    mesh = _mesh_for(cfg)
    key = jax.random.PRNGKey(cfg.seed)
    metrics = MetricsLogger(stream=None)

    if cfg.horizon > 0:
        # time-dependent MPC scenario
        from .control import MPCConfig, gaussian_actuators, receding_horizon
        x = mesh.nodes[:, 0]
        target_field = 0.3 * jnp.sin(jnp.pi * x)
        mcfg = MPCConfig(horizon=cfg.horizon, dt=cfg.dt, lr=0.3,
                         plan_iters=cfg.n_opt_steps, control_penalty=1e-6)
        target = jnp.broadcast_to(target_field, (cfg.horizon, mesh.n_nodes))
        act = gaussian_actuators(mesh, [0.25, 0.5, 0.75], width=0.1)
        states, controls = receding_horizon(
            mesh, 1.0, jnp.zeros(mesh.n_nodes, mesh.dtype), act, target,
            mcfg, n_mpc_steps=10)
        free = mesh.free_nodes()
        err = float(jnp.max(jnp.abs(states[-1][free] - target_field[free])))
        result = {"scenario": cfg.name, "tracking_error": err}

    elif cfg.name == "topopt_2d":
        from .control import TopOptConfig, optimize
        tcfg = TopOptConfig(nx=cfg.n_elements, ny=cfg.n_elements,
                            n_iters=cfg.n_opt_steps)
        f = jnp.ones(mesh.n_nodes, mesh.dtype)
        rho, hist = optimize(mesh, f, tcfg)
        result = {"scenario": cfg.name,
                  "compliance_initial": float(hist[0]),
                  "compliance_final": float(hist[-1]),
                  "volume": float(jnp.mean(rho))}

    else:
        # (batched) κ-recovery inverse problem
        import optax
        B = cfg.batch
        x = mesh.nodes[:, 0]
        k_true = 1.0 + jax.random.uniform(key, (B,), mesh.dtype) * 2.0
        f = jnp.broadcast_to(jnp.sin(jnp.pi * x) + 1.0, (B, mesh.n_nodes))
        u_data = solve_poisson_batched(mesh, k_true, f, method=cfg.method,
                                       kappa_batched=True)

        def loss_fn(log_k):
            u = solve_poisson_batched(mesh, jnp.exp(log_k), f,
                                      method=cfg.method, kappa_batched=True)
            return jnp.mean((u - u_data) ** 2)

        opt = optax.adam(cfg.lr)
        log_k = jnp.zeros((B,), mesh.dtype)
        state = opt.init(log_k)

        @jax.jit
        def step(log_k, state):
            loss, g = jax.value_and_grad(loss_fn)(log_k)
            updates, state = opt.update(g, state)
            return optax.apply_updates(log_k, updates), state, loss

        for i in range(cfg.n_opt_steps):
            log_k, state, loss = step(log_k, state)
            if i % max(1, cfg.n_opt_steps // 5) == 0:
                metrics.log(i, loss=float(loss))
        err = float(jnp.max(jnp.abs(jnp.exp(log_k) - k_true)))
        result = {"scenario": cfg.name, "batch": B,
                  "kappa_max_error": err, "final_loss": float(loss)}

    log(json.dumps(result))
    return result


def bench_scenario(cfg, log=print):
    """Throughput of one fwd+adjoint step for the scenario's workload."""
    from .solver import solve_poisson_batched
    from .utils.profiling import timeit_jax

    if cfg.dim == 2:
        # config-4 shape: batched per-triangle κ-field inversion on the
        # structured-grid production path (fixed-iteration PCG)
        from .ops.stencil import StructuredGrid, solve_poisson_structured
        if cfg.dtype == "f64":
            jax.config.update("jax_enable_x64", True)
        dtype = jnp.float64 if cfg.dtype == "f64" else jnp.float32
        n = cfg.n_elements
        B = cfg.batch
        grid = StructuredGrid.unit(n, n)
        key = jax.random.PRNGKey(cfg.seed)
        xs = jnp.linspace(0, 1, n + 1, dtype=dtype)
        X, Y = jnp.meshgrid(xs, xs)
        f = (jnp.sin(jnp.pi * X) * jnp.sin(jnp.pi * Y)).astype(dtype)
        fB = jnp.broadcast_to(f, (B, n + 1, n + 1))
        klB = 1.0 + jax.random.uniform(key, (B, n, n), dtype)
        g0 = jnp.zeros((n + 1, n + 1), dtype)
        iters = cfg.extra.get("cg_iters", 128)
        solve = jax.vmap(lambda kl, ff: solve_poisson_structured(
            grid, (kl, kl), ff, g0, 0.0, iters))
        u_data = jax.jit(solve)(klB, fB)

        def loss_fn(kl):
            return jnp.mean((solve(kl, fB) - u_data) ** 2)

        step = jax.jit(jax.value_and_grad(loss_fn))
        timing = timeit_jax(step, klB, iters=10)
        result = {"scenario": cfg.name, "batch": B, "grid": f"{n}x{n}",
                  "cg_iters": iters,
                  "grad_solves_per_s": round(timing.throughput(B), 1),
                  "step_ms": round(timing.mean_ms, 3)}
        log(json.dumps(result))
        return result

    mesh = _mesh_for(cfg)
    key = jax.random.PRNGKey(cfg.seed)
    B = cfg.batch
    x = mesh.nodes[:, 0]
    k_true = 1.0 + jax.random.uniform(key, (B,), mesh.dtype) * 2.0
    f = jnp.broadcast_to(jnp.sin(jnp.pi * x) + 1.0, (B, mesh.n_nodes))
    u_data = solve_poisson_batched(mesh, k_true, f, method=cfg.method,
                                   kappa_batched=True)

    def loss_fn(log_k):
        u = solve_poisson_batched(mesh, jnp.exp(log_k), f, method=cfg.method,
                                  kappa_batched=True)
        return jnp.mean((u - u_data) ** 2)

    step = jax.jit(jax.value_and_grad(loss_fn))
    timing = timeit_jax(step, jnp.zeros((B,), mesh.dtype), iters=20)
    result = {"scenario": cfg.name, "batch": B,
              "grad_solves_per_s": round(timing.throughput(B), 1),
              "step_ms": round(timing.mean_ms, 3)}
    log(json.dumps(result))
    return result


def invert_workload(dim: int, n: int, batch: int, seed: int = 0,
                    unstructured: bool = False):
    """The ``invert`` workload: a float32 unit line/square/cube mesh with
    ``n`` elements per side, random per-element κ_true ∈ [1.2, 1.8], the
    shared forcing dim·π²·Πsin(πx), and converged observations.

    ``unstructured`` (2D only) perturbs the interior nodes by up to 0.3·h
    and drops the grid metadata, so nothing structured is left to exploit
    and ``fit_kappa`` takes the edge-ELL route at B ≥ 128.  Returns
    (mesh, fB, u_data, k_true)."""
    import math
    from .mesh import FEMesh
    from .solver import solve_poisson_batched

    if dim == 1:
        mesh = FEMesh.line(n_elements=n, dtype=jnp.float32)
    elif dim == 2:
        mesh = FEMesh.rectangle(nx=n, ny=n, dtype=jnp.float32)
    else:
        mesh = FEMesh.box(nx=n, ny=n, nz=n, dtype=jnp.float32)
    if unstructured:
        # grid=None is REQUIRED: grid metadata asserts factory geometry,
        # and keeping it on a perturbed mesh would mis-route to the
        # stencil solvers.
        import numpy as np
        if dim != 2:
            raise SystemExit("--unstructured supports --dim 2")
        nodes = np.asarray(mesh.nodes).copy()
        rng = np.random.RandomState(seed)
        interior = np.asarray(mesh.bc_mask) < 0.5
        h = 1.0 / n
        nodes[interior] += rng.uniform(-0.3 * h, 0.3 * h,
                                       nodes[interior].shape)
        mesh = dataclasses.replace(mesh, nodes=jnp.asarray(
            nodes, mesh.dtype), grid=None)
    pi = math.pi
    f = (dim * pi ** 2) * jnp.prod(jnp.sin(pi * mesh.nodes), axis=1)
    fB = jnp.broadcast_to(f, (batch, mesh.n_nodes))
    k_true = 1.2 + 0.6 * jax.random.uniform(
        jax.random.PRNGKey(seed), (batch, mesh.n_elements), jnp.float32)
    if dim == 1:
        # exact band solve — the 1D observation generator
        u_data = solve_poisson_batched(mesh, k_true, fB, method="tridiag")
    else:
        u_data = solve_poisson_batched(mesh, k_true, fB,
                                       cg_tol=0.0, cg_maxiter=300)
    return mesh, fB, u_data, k_true


def invert_cmd(args):
    """Production κ-field inversion on the routed fast paths (fit_kappa).

    Synthesizes :func:`invert_workload`, runs ``fit_kappa`` with the
    default policy, and reports throughput + honest converged eval loss
    + κ error.
    """
    import time
    from .inverse import fit_kappa

    n = args.elements if args.elements is not None \
        else {1: 30, 2: 64, 3: 16}[args.dim]
    B, steps = args.batch, args.steps
    mesh, fB, u_data, k_true = invert_workload(
        args.dim, n, B, args.seed, getattr(args, "unstructured", False))
    jax.block_until_ready(u_data)

    kw = dict(steps=steps, lr=args.lr,
              iters=args.iters, eval_final=True)
    kappa, info = fit_kappa(mesh, fB, u_data, **kw)     # compile + run
    jax.block_until_ready(info["loss_history"])
    t0 = time.perf_counter()
    kappa, info = fit_kappa(mesh, fB, u_data, **kw)     # timed (cached jit)
    jax.block_until_ready(info["loss_history"])
    dt = time.perf_counter() - t0
    kerr = float(jnp.max(jnp.abs(kappa - k_true)) / jnp.max(k_true))
    print(json.dumps({
        "dim": args.dim, "elements": n, "batch": B, "steps": steps,
        "path": info["path"], "iters": info["iters"], "warm": info["warm"],
        "grad_solves_per_s": round(B * steps / dt, 1),
        "final_loop_loss": float(info["loss_history"][-1]),
        "eval_loss": info["eval_loss"],
        "kappa_rel_err": kerr,
    }))
    return 0


def export_cmd(args):
    """Build an AOT solver artifact for a mesh/batch and write it to disk."""
    from .mesh import FEMesh
    from .utils.export import export_batched_solver, export_gradient_step
    mesh = FEMesh.line(n_elements=args.elements) if args.dim == 1 \
        else FEMesh.rectangle(nx=args.elements, ny=args.elements)
    build = export_gradient_step if args.grad else export_batched_solver
    blob = build(mesh, batch=args.batch)
    with open(args.out, "wb") as fh:
        fh.write(blob)
    print(json.dumps({"artifact": args.out, "bytes": len(blob),
                      "dim": args.dim, "elements": args.elements,
                      "batch": args.batch, "grad": bool(args.grad)}))
    return 0


def serve_cmd(args):
    """Serve an exported artifact: JSON lines on stdin → JSON lines on stdout.

    Request:  {"kappa": [...B], "f": [[...n]...B]}   (and "u_data" for grad
    artifacts).  Response: {"u": [[...]]} or {"loss": .., "grad": [...]}.
    """
    from .utils.export import load_exported_with_avals
    with open(args.artifact, "rb") as fh:
        fn, avals = load_exported_with_avals(fh.read())
    dtypes = [a.dtype for a in avals]
    if any(d == jnp.float64 for d in dtypes):
        jax.config.update("jax_enable_x64", True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if "u_data" in req:
                loss, grad = fn(jnp.asarray(req["kappa"], dtypes[0]),
                                jnp.asarray(req["f"], dtypes[1]),
                                jnp.asarray(req["u_data"], dtypes[2]))
                print(json.dumps({"loss": float(loss),
                                  "grad": grad.tolist()}), flush=True)
            else:
                u = fn(jnp.asarray(req["kappa"], dtypes[0]),
                       jnp.asarray(req["f"], dtypes[1]))
                print(json.dumps({"u": u.tolist()}), flush=True)
        except Exception as e:  # malformed request: report, keep serving
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
                  flush=True)
    return 0


def main(argv=None):
    from .utils.compile_cache import configure_compile_cache
    from .utils.config import BASELINE_CONFIGS, ScenarioConfig

    configure_compile_cache()

    parser = argparse.ArgumentParser(prog="difffe_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list scenarios")
    for cmd in ("run", "bench"):
        p = sub.add_parser(cmd)
        p.add_argument("scenario", choices=sorted(BASELINE_CONFIGS))
        p.add_argument("--batch", type=int)
        p.add_argument("--steps", type=int)
        p.add_argument("--method")
    pi_ = sub.add_parser("invert", help="κ-field inversion on the routed "
                                        "fast paths (fit_kappa)")
    pi_.add_argument("--dim", type=int, default=2, choices=[1, 2, 3])
    pi_.add_argument("--elements", type=int, default=None,
                     help="per side (default: 30 for 1D, 64 for 2D, "
                          "16 for 3D)")
    pi_.add_argument("--batch", type=int, default=256)
    pi_.add_argument("--steps", type=int, default=100)
    pi_.add_argument("--lr", type=float, default=None)
    pi_.add_argument("--iters", type=int, default=None)
    pi_.add_argument("--seed", type=int, default=0)
    pi_.add_argument("--unstructured", action="store_true",
                     help="perturb interior nodes (irregular "
                          "triangulation) — routes to the batch-minor "
                          "edge-ELL inversion at B>=128")
    pe = sub.add_parser("export", help="build an AOT solver artifact")
    pe.add_argument("out")
    pe.add_argument("--dim", type=int, default=1, choices=[1, 2])
    pe.add_argument("--elements", type=int, default=64)
    pe.add_argument("--batch", type=int, default=256)
    pe.add_argument("--grad", action="store_true",
                    help="export the fwd+adjoint gradient step")
    ps = sub.add_parser("serve", help="serve an artifact over stdin/stdout")
    ps.add_argument("artifact")
    args = parser.parse_args(argv)

    if args.cmd == "list":
        for name, cfg in BASELINE_CONFIGS.items():
            print(f"{name:24s} {cfg.to_json()}")
        return 0
    if args.cmd == "invert":
        return invert_cmd(args)
    if args.cmd == "export":
        return export_cmd(args)
    if args.cmd == "serve":
        return serve_cmd(args)

    cfg = BASELINE_CONFIGS[args.scenario]
    overrides = {}
    if args.batch:
        overrides["batch"] = args.batch
    if args.steps:
        overrides["n_opt_steps"] = args.steps
    if args.method:
        overrides["method"] = args.method
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    if args.cmd == "run":
        run_scenario(cfg)
    else:
        bench_scenario(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
