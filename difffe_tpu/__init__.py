"""difffe_tpu — batched differentiable finite elements in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``danieleschmidt/DiffFE-Physics-Lab`` (reference at /root/reference):
differentiable FEM solves of −∇·(κ∇u)=f on 1D/2D/3D P1 meshes, adjoint
gradients through u = K⁻¹F, physics-loss neural training, and κ-recovery
inverse problems — engineered for batched multi-device GPU execution
(jit/shard_map over device meshes, custom-VJP solvers, matrix-free
operators, a Pallas-Triton kernel for the 1D inversion chain).

Public API mirrors the reference's four exports
(/root/reference/diffhe/__init__.py:12) plus the functional core.
"""

from .mesh import FEMesh, default_dtype
from .solver import DifferentiableFESolver, solve_poisson, solve_poisson_batched

__version__ = "0.1.0"

__all__ = [
    "FEMesh",
    "DifferentiableFESolver",
    "solve_poisson",
    "solve_poisson_batched",
    "default_dtype",
    "PhysicsLoss",
    "NeuralPDE",
    "recover_kappa_scalar",
    "recover_kappa_field",
    "fit_kappa",
    "train_collocation",
    "build_ell",
    "solve_poisson_cg_ell",
    "StructuredGrid3",
    "solve_poisson_structured_3d",
    "solve_poisson_structured_3d_batched",
    "choose_3d_path",
    "solve_poisson_cg_ell_batched",
    "solve_poisson_cf_batched",
    "kappa_sgd_chain_cf",
]


def __getattr__(name):
    # Lazy imports keep `import difffe_tpu` light and avoid import cycles.
    if name == "PhysicsLoss":
        from .losses import PhysicsLoss
        return PhysicsLoss
    if name == "NeuralPDE":
        from .models.neural import NeuralPDE
        return NeuralPDE
    if name == "recover_kappa_scalar":
        from .inverse import recover_kappa_scalar
        return recover_kappa_scalar
    if name == "recover_kappa_field":
        from .inverse import recover_kappa_field
        return recover_kappa_field
    if name == "fit_kappa":
        from .inverse import fit_kappa
        return fit_kappa
    if name == "train_collocation":
        from .models.collocation import train_collocation
        return train_collocation
    if name == "build_ell":
        from .ops.unstructured import build_ell
        return build_ell
    if name == "solve_poisson_cg_ell":
        from .ops.unstructured import solve_poisson_cg_ell
        return solve_poisson_cg_ell
    if name == "solve_poisson_cg_ell_batched":
        from .ops.unstructured import solve_poisson_cg_ell_batched
        return solve_poisson_cg_ell_batched
    if name == "solve_poisson_cf_batched":
        from .ops.cf1d import solve_poisson_cf_batched
        return solve_poisson_cf_batched
    if name == "kappa_sgd_chain_cf":
        from .ops.pallas.fused_grad_cf_kernel import kappa_sgd_chain_cf
        return kappa_sgd_chain_cf
    if name in ("StructuredGrid3", "solve_poisson_structured_3d",
                "solve_poisson_structured_3d_batched", "choose_3d_path"):
        from .ops import stencil3d
        return getattr(stencil3d, name)
    raise AttributeError(f"module 'difffe_tpu' has no attribute {name!r}")
