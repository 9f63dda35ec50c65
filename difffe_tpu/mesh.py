"""Finite element mesh.

Design (vs. reference ``diffhe/mesh.py``, /root/reference/diffhe/mesh.py:14-143):
the reference stores Dirichlet BCs as a Python ``Dict[int, float]`` and exposes
``free_nodes()`` as a Python list comprehension — both incompatible with
``jax.jit``/``vmap``.  Here the mesh is a registered JAX pytree whose BCs are
dense arrays (``bc_mask`` ∈ {0,1} per node, ``bc_values`` per node), so every
downstream op keeps **static shapes** and is trace-compatible.  Factories are
pure vectorized index arithmetic (no Python loops, unlike mesh.py:100-120),
so meshes can be built inside jit-traced code.

Capability parity (checked against reference behavior):
  * ``FEMesh.line(n_elements, x_left, x_right, bc_left, bc_right)``
    — uniform interval mesh, default u(0)=u(1)=0; ``bc_left=None`` omits a BC
    (mesh.py:58-77).
  * ``FEMesh.rectangle(nx, ny, x_range, y_range, bc_value)`` — uniform grid,
    each quad split into two triangles along the lower-left diagonal
    (mesh.py:100-105), all four boundary edges Dirichlet (mesh.py:111-120).
  * ``free_nodes() / h() / n_nodes / n_elements / dim`` queries
    (mesh.py:42-52,127-136); ``h()`` is implemented for 2D as well (the
    reference raises NotImplementedError for dim>1, mesh.py:136).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def default_dtype() -> jnp.dtype:
    """float64 when x64 is enabled (golden/accuracy path), else float32.

    The reference is float64-CPU-only (solver.py:39); here the production
    path is f32 with an opt-in f64 golden path for the 1e-16 exactness
    claims (see SURVEY.md §7 'Hard parts').
    """
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FEMesh:
    """A finite element mesh with nodes, elements, and Dirichlet BCs.

    Attributes
    ----------
    nodes : (n_nodes, dim) float array — physical node coordinates.
    elements : (n_elements, nodes_per_element) int32 — connectivity.
    bc_mask : (n_nodes,) float array — 1.0 on Dirichlet nodes, 0.0 elsewhere.
    bc_values : (n_nodes,) float array — prescribed value on Dirichlet nodes
        (0.0 elsewhere; only read where ``bc_mask == 1``).
    """

    nodes: jax.Array
    elements: jax.Array
    bc_mask: jax.Array
    bc_values: jax.Array
    #: Structured-grid metadata (``ops.stencil.StructuredGrid`` for
    #: ``rectangle``, ``ops.stencil3d.StructuredGrid3`` for ``box``) — static
    #: pytree aux data.  When present, ``solve_poisson(method="auto")`` routes
    #: to the closed-form stencil fast paths instead of generic gather-based
    #: CG.  Factories set it; any
    #: operation that breaks the structured assumptions (``with_dirichlet``)
    #: drops it, falling back to the general paths.
    grid: Optional[object] = dataclasses.field(
        default=None, metadata=dict(static=True))

    # ---------------------------------------------------------------- queries

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_elements(self) -> int:
        return self.elements.shape[0]

    @property
    def dim(self) -> int:
        return self.nodes.shape[1]

    @property
    def dtype(self) -> jnp.dtype:
        return self.nodes.dtype

    @property
    def n_dirichlet(self) -> int:
        """Number of Dirichlet-constrained nodes (concrete meshes only)."""
        return int(np.sum(np.asarray(self.bc_mask) > 0.5))

    def free_nodes(self) -> np.ndarray:
        """Indices of unconstrained nodes (reference mesh.py:127-129).

        Returns a host numpy array — intended for test/analysis code; jitted
        code should use ``bc_mask`` directly.
        """
        return np.nonzero(np.asarray(self.bc_mask) < 0.5)[0]

    def dirichlet_items(self):
        """(node_index, value) pairs, mirroring the reference's BC dict."""
        idx = np.nonzero(np.asarray(self.bc_mask) > 0.5)[0]
        vals = np.asarray(self.bc_values)[idx]
        return list(zip(idx.tolist(), vals.tolist()))

    def h(self) -> float:
        """Characteristic element size = minimum edge length (mesh.py:131-136).

        Unlike the reference, also implemented for 2D (min over all three
        triangle edges).
        """
        nodes, elems = self.nodes, self.elements
        if self.dim == 1:
            d = jnp.abs(nodes[elems[:, 1], 0] - nodes[elems[:, 0], 0])
            return float(jnp.min(d))
        # 2D/3D simplices: min over all vertex-pair edges of every element
        p = nodes[elems]  # (ne, k, dim)
        k = p.shape[1]
        lengths = [jnp.linalg.norm(p[:, b] - p[:, a], axis=-1)
                   for a in range(k) for b in range(a + 1, k)]
        return float(jnp.min(jnp.stack(lengths)))

    def __repr__(self) -> str:  # mirrors reference mesh.py:138-143
        return (
            f"FEMesh(dim={self.dim}, n_nodes={self.n_nodes}, "
            f"n_elements={self.n_elements}, n_dirichlet={self.n_dirichlet})"
        )

    # -------------------------------------------------------------- factories

    @classmethod
    def line(
        cls,
        n_elements: int = 10,
        x_left: float = 0.0,
        x_right: float = 1.0,
        bc_left: Optional[float] = 0.0,
        bc_right: Optional[float] = 0.0,
        dtype: Optional[jnp.dtype] = None,
    ) -> "FEMesh":
        """Uniform 1D mesh on [x_left, x_right] with Dirichlet BCs.

        Matches reference semantics (mesh.py:58-77): N+1 nodes, N intervals;
        passing ``bc_left=None`` / ``bc_right=None`` omits that constraint.
        """
        dtype = dtype or default_dtype()
        n = n_elements + 1
        x = jnp.linspace(x_left, x_right, n, dtype=dtype)
        nodes = x[:, None]
        idx = jnp.arange(n_elements, dtype=jnp.int32)
        elements = jnp.stack([idx, idx + 1], axis=1)

        bc_mask = jnp.zeros(n, dtype=dtype)
        bc_values = jnp.zeros(n, dtype=dtype)
        if bc_left is not None:
            bc_mask = bc_mask.at[0].set(1.0)
            bc_values = bc_values.at[0].set(bc_left)
        if bc_right is not None:
            bc_mask = bc_mask.at[n - 1].set(1.0)
            bc_values = bc_values.at[n - 1].set(bc_right)
        return cls(nodes=nodes, elements=elements, bc_mask=bc_mask,
                   bc_values=bc_values)

    @classmethod
    def rectangle(
        cls,
        nx: int = 4,
        ny: int = 4,
        x_range: Tuple[float, float] = (0.0, 1.0),
        y_range: Tuple[float, float] = (0.0, 1.0),
        bc_value: float = 0.0,
        dtype: Optional[jnp.dtype] = None,
    ) -> "FEMesh":
        """Uniform 2D triangulated grid, Dirichlet on all four boundary edges.

        Node numbering and the lower-left diagonal quad split match the
        reference (mesh.py:92-105): node id = row*(nx+1)+col, quad
        (a,b,c,d) → triangles (a,b,d) and (b,c,d).  Built with vectorized
        index arithmetic instead of the reference's Python double loop.
        """
        dtype = dtype or default_dtype()
        xs = jnp.linspace(x_range[0], x_range[1], nx + 1, dtype=dtype)
        ys = jnp.linspace(y_range[0], y_range[1], ny + 1, dtype=dtype)
        xx, yy = jnp.meshgrid(xs, ys)  # (ny+1, nx+1), row-major like reference
        nodes = jnp.stack([xx.ravel(), yy.ravel()], axis=1)

        # Quad corner ids, vectorized: i = row (y), j = col (x)
        i = jnp.arange(ny, dtype=jnp.int32)[:, None]  # (ny, 1)
        j = jnp.arange(nx, dtype=jnp.int32)[None, :]  # (1, nx)
        a = (i * (nx + 1) + j).ravel()
        b = (i * (nx + 1) + j + 1).ravel()
        c = ((i + 1) * (nx + 1) + j + 1).ravel()
        d = ((i + 1) * (nx + 1) + j).ravel()
        lower = jnp.stack([a, b, d], axis=1)  # lower-left triangle
        upper = jnp.stack([b, c, d], axis=1)  # upper-right triangle
        # Interleave to match reference element ordering: [low_0, up_0, low_1, ...]
        elements = jnp.stack([lower, upper], axis=1).reshape(-1, 3)

        # Boundary detection by INDEX, not coordinates: coordinate isclose
        # tests misclassify nodes on tiny or large-offset domains (default
        # rtol 1e-5 of a 1e7 offset swallows whole rows of nodes).
        rows = jnp.arange(NY := ny + 1, dtype=jnp.int32)[:, None]
        cols = jnp.arange(NX := nx + 1, dtype=jnp.int32)[None, :]
        on_bnd = ((rows == 0) | (rows == ny)
                  | (cols == 0) | (cols == nx)).ravel()
        bc_mask = on_bnd.astype(dtype)
        bc_values = bc_mask * jnp.asarray(bc_value, dtype=dtype)
        from .ops.stencil import StructuredGrid
        grid = StructuredGrid.unit(nx, ny, x_range, y_range)
        return cls(nodes=nodes, elements=elements, bc_mask=bc_mask,
                   bc_values=bc_values, grid=grid)

    @classmethod
    def box(
        cls,
        nx: int = 4,
        ny: int = 4,
        nz: int = 4,
        x_range: Tuple[float, float] = (0.0, 1.0),
        y_range: Tuple[float, float] = (0.0, 1.0),
        z_range: Tuple[float, float] = (0.0, 1.0),
        bc_value: float = 0.0,
        dtype: Optional[jnp.dtype] = None,
    ) -> "FEMesh":
        """Uniform 3D box mesh of P1 tetrahedra, Dirichlet on all six faces.

        BEYOND the reference: its solver raises NotImplementedError for
        dim>2 (/root/reference/diffhe/solver.py:62-67) and FEMesh has no 3D
        factory.  Node id = (iz·(ny+1) + iy)·(nx+1) + ix (x fastest, the 3D
        extension of the rectangle numbering).  Each cube is split into the
        SIX Kuhn tetrahedra sharing the main diagonal c000–c111 (one per
        monotone lattice path 000→111) — a conforming triangulation with
        equal volumes h³/6, the canonical 3D analogue of the rectangle
        factory's lower-left diagonal split.  Boundary detection by INDEX
        (same rationale as ``rectangle``).
        """
        dtype = dtype or default_dtype()
        xs = jnp.linspace(x_range[0], x_range[1], nx + 1, dtype=dtype)
        ys = jnp.linspace(y_range[0], y_range[1], ny + 1, dtype=dtype)
        zs = jnp.linspace(z_range[0], z_range[1], nz + 1, dtype=dtype)
        zz, yy, xx = jnp.meshgrid(zs, ys, xs, indexing="ij")
        nodes = jnp.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)

        i = jnp.arange(nx, dtype=jnp.int32)[None, None, :]
        j = jnp.arange(ny, dtype=jnp.int32)[None, :, None]
        k = jnp.arange(nz, dtype=jnp.int32)[:, None, None]

        def corner(di, dj, dk):
            return (((k + dk) * (ny + 1) + (j + dj)) * (nx + 1)
                    + (i + di)).ravel()

        c = {(di, dj, dk): corner(di, dj, dk)
             for di in (0, 1) for dj in (0, 1) for dk in (0, 1)}
        # six monotone paths 000→111; each tet = {000, step1, step2, 111}
        paths = [
            ((1, 0, 0), (1, 1, 0)),  # x then y (then z)
            ((1, 0, 0), (1, 0, 1)),  # x then z
            ((0, 1, 0), (1, 1, 0)),  # y then x
            ((0, 1, 0), (0, 1, 1)),  # y then z
            ((0, 0, 1), (1, 0, 1)),  # z then x
            ((0, 0, 1), (0, 1, 1)),  # z then y
        ]
        tets = [jnp.stack([c[(0, 0, 0)], c[p1], c[p2], c[(1, 1, 1)]], axis=1)
                for p1, p2 in paths]
        # interleave per cube: [cube0 tet0..5, cube1 tet0..5, ...]
        elements = jnp.stack(tets, axis=1).reshape(-1, 4)

        ii = jnp.arange(nx + 1, dtype=jnp.int32)[None, None, :]
        jj = jnp.arange(ny + 1, dtype=jnp.int32)[None, :, None]
        kk = jnp.arange(nz + 1, dtype=jnp.int32)[:, None, None]
        on_bnd = ((ii == 0) | (ii == nx) | (jj == 0) | (jj == ny)
                  | (kk == 0) | (kk == nz))
        on_bnd = jnp.broadcast_to(
            on_bnd, (nz + 1, ny + 1, nx + 1)).ravel()
        bc_mask = on_bnd.astype(dtype)
        bc_values = bc_mask * jnp.asarray(bc_value, dtype=dtype)
        from .ops.stencil3d import StructuredGrid3
        grid = StructuredGrid3.unit(nx, ny, nz, x_range, y_range, z_range)
        return cls(nodes=nodes, elements=elements, bc_mask=bc_mask,
                   bc_values=bc_values, grid=grid)

    @classmethod
    def line_p2(cls, n_elements: int = 10, **kw) -> "FEMesh":
        """Quadratic (P2) 1D mesh — beyond the reference's P1-only support
        (its roadmap item, /root/reference/README.md:139-143).  See
        ops/p2.py."""
        from .ops.p2 import line_p2 as _line_p2
        return _line_p2(n_elements, **kw)

    @classmethod
    def rectangle_p2(cls, nx: int = 4, ny: int = 4, **kw) -> "FEMesh":
        """Quadratic (P2) 2D triangulated grid (6-node triangles)."""
        from .ops.p2 import rectangle_p2 as _rectangle_p2
        return _rectangle_p2(nx, ny, **kw)

    # ------------------------------------------------------------------ misc

    def astype(self, dtype: jnp.dtype) -> "FEMesh":
        """Cast all float fields to ``dtype`` (elements stay int32)."""
        return FEMesh(
            nodes=self.nodes.astype(dtype),
            elements=self.elements,
            bc_mask=self.bc_mask.astype(dtype),
            bc_values=self.bc_values.astype(dtype),
            grid=self.grid,
        )

    def with_dirichlet(self, node_indices, values) -> "FEMesh":
        """Return a copy with additional/overridden Dirichlet constraints."""
        node_indices = jnp.asarray(node_indices, dtype=jnp.int32)
        values = jnp.broadcast_to(
            jnp.asarray(values, dtype=self.dtype), node_indices.shape
        )
        bc_mask = self.bc_mask.at[node_indices].set(1.0)
        bc_values = self.bc_values.at[node_indices].set(values)
        # custom constraints break the full-boundary-Dirichlet assumption of
        # the structured stencil paths — drop the metadata so method="auto"
        # falls back to the general (mask-based) paths.
        return FEMesh(self.nodes, self.elements, bc_mask, bc_values)
