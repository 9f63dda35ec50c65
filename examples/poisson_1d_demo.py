"""1D Poisson demo — the reference's flagship walkthrough in JAX.

Reproduces /root/reference/examples/poisson_1d_demo.py's three stages with
the same published numbers (reference README 'Expected output'):
  1. FEM solve of −u″=1 on 20 elements vs exact x(1−x)/2 → ~1e-16 max error
  2. NeuralPDE (64 hidden, 3 layers) trained 3000 epochs fem_match
  3. κ-recovery inverse problem: data from κ=2, 200 Adam steps → κ ≈ 2.0000

Run: python examples/poisson_1d_demo.py  [--f32]
(defaults to the float64 golden path; --f32 uses the production dtype)
"""

import sys

import jax

if "--f32" not in sys.argv:
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import optax

from difffe_tpu import FEMesh, NeuralPDE, solve_poisson


def main():
    # ------------------------------------------------------------- stage 1
    print("=== 1. FEM solve: -u'' = 1, u(0)=u(1)=0 ===")
    mesh = FEMesh.line(n_elements=20)
    x = mesh.nodes[:, 0]
    u_fem = solve_poisson(mesh, 1.0, jnp.ones_like(x))
    u_exact = x * (1.0 - x) / 2.0
    print(f"  max |u_fem - u_exact| = {float(jnp.max(jnp.abs(u_fem - u_exact))):.2e}")

    # ------------------------------------------------------------- stage 2
    print("=== 2. NeuralPDE surrogate (3000 epochs, fem_match) ===")
    model = NeuralPDE(mesh, hidden_dim=64, n_layers=3,
                      key=jax.random.PRNGKey(42))
    losses = model.train_pde(jnp.ones_like, n_epochs=3000, lr=1e-3,
                             verbose=True, log_every=500)
    u_nn = model()
    print(f"  final loss = {losses[-1]:.2e}")
    print(f"  max |u_nn - u_exact| = {float(jnp.max(jnp.abs(u_nn - u_exact))):.2e}")

    # node-wise comparison table, as the reference demo prints
    # (/root/reference/examples/poisson_1d_demo.py:78-86)
    print("  node-wise comparison (every 4th node):")
    print(f"  {'x':>8} {'u_fem':>12} {'u_nn':>12} {'u_exact':>12}")
    for i in range(0, mesh.n_nodes, 4):
        print(f"  {float(x[i]):8.3f} {float(u_fem[i]):12.6f} "
              f"{float(u_nn[i]):12.6f} {float(u_exact[i]):12.6f}")

    # ------------------------------------------------------------- stage 3
    print("=== 3. kappa recovery (true kappa = 2.0) ===")
    mesh30 = FEMesh.line(n_elements=30)
    x30 = mesh30.nodes[:, 0]
    f_ref = jnp.sin(jnp.pi * x30) + 1.0
    u_data = solve_poisson(mesh30, 2.0, f_ref)

    def loss_fn(kappa_raw):
        # |κ| reparameterization for positivity, as the reference does
        # (poisson_1d_demo.py:106 kappa_est.abs())
        u_est = solve_poisson(mesh30, jnp.abs(kappa_raw), f_ref)
        return jnp.mean((u_est - u_data) ** 2)

    opt = optax.adam(0.1)
    kappa = jnp.asarray(1.0, mesh30.dtype)
    state = opt.init(kappa)

    @jax.jit
    def step(kappa, state):
        loss, g = jax.value_and_grad(loss_fn)(kappa)
        updates, state = opt.update(g, state)
        return optax.apply_updates(kappa, updates), state, loss

    for i in range(200):
        kappa, state, loss = step(kappa, state)
    print(f"  recovered kappa = {float(jnp.abs(kappa)):.4f}")


if __name__ == "__main__":
    main()
