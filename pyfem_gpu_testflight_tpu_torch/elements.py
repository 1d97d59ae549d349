"""Element definitions: quadrature rules + shape-function tables.

NumPy copy of ``pyfem_gpu_testflight_tpu.elements`` (the reference
package's ``__init__`` imports jax, so the port carries its own).  An
element type is nothing but a set of *static tables* — quadrature
points/weights and the shape values/derivatives tabulated at those
points, computed once at registry time.

Behavioral parity: the five element types of the reference
(pyfem.py:19-631) — quad4 (2x2 Gauss), tri3 (1-pt centroid), hex8
(2x2x2 Gauss), tet10 (5-pt rule), brick20 (3x3x3 Gauss).  The tet rule
keeps the reference's weight normalization (weights sum to 1 rather than
1/6, pyfem.py:115-134); the scale cancels between K and rhs so solves are
unaffected, and sensitivity checks are self-consistent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ElementType", "get_element", "register_element", "ELEMENT_REGISTRY"]


@dataclasses.dataclass(frozen=True)
class ElementType:
    """Immutable bundle of element tables.

    Attributes:
        name: canonical element name.
        ndims: number of spatial dimensions (2 or 3).
        nnodes: nodes per element.
        quad_pts: (nquads, ndims) quadrature points in local coordinates.
        quad_wts: (nquads,) quadrature weights.
        shape_vals: N, (nquads, nnodes) shape function values.
        shape_grads: dN, (nquads, nnodes, ndims) local derivatives.
    """

    name: str
    ndims: int
    nnodes: int
    quad_pts: np.ndarray
    quad_wts: np.ndarray
    shape_vals: np.ndarray
    shape_grads: np.ndarray
    node_coords: np.ndarray  # (nnodes, ndims) local coordinates of nodes

    @property
    def nquads(self) -> int:
        return self.quad_pts.shape[0]

    def __repr__(self) -> str:  # keep dataclass arrays out of reprs
        return (
            f"ElementType({self.name}, ndims={self.ndims}, "
            f"nnodes={self.nnodes}, nquads={self.nquads})"
        )


# ---------------------------------------------------------------------------
# Quadrature rules
# ---------------------------------------------------------------------------


def _gauss_legendre_2pt():
    g = 1.0 / np.sqrt(3.0)
    return np.array([-g, g]), np.array([1.0, 1.0])


def _gauss_legendre_3pt():
    g = np.sqrt(3.0 / 5.0)
    return np.array([-g, 0.0, g]), np.array([5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0])


def _tensor_rule(pts1d, wts1d, ndims):
    """Tensor-product Gauss rule with the *first* axis varying fastest.

    Matches the reference's point orderings: quad4 uses a custom circular
    order (handled separately), hex8/brick20 use lexicographic with x
    fastest (pyfem.py:97-172).
    """
    n = len(pts1d)
    idx = np.stack(
        np.meshgrid(*([np.arange(n)] * ndims), indexing="ij"), axis=-1
    ).reshape(-1, ndims)
    # meshgrid 'ij' makes the LAST axis fastest when reshaped; we want the
    # first coordinate fastest like the reference loops, so flip columns.
    idx = idx[:, ::-1]
    pts = pts1d[idx]
    wts = np.prod(wts1d[idx], axis=1)
    return pts, wts


def _quad4_rule():
    # Reference order: (-g,-g), (g,-g), (g,g), (-g,g) — pyfem.py:83-94
    g = 1.0 / np.sqrt(3.0)
    pts = np.array([[-g, -g], [g, -g], [g, g], [-g, g]])
    wts = np.ones(4)
    return pts, wts


def _hex8_rule():
    # Reference order: x slowest, z fastest — pyfem.py:97-112
    g = 1.0 / np.sqrt(3.0)
    pts = np.array(
        [
            [-g, -g, -g],
            [-g, -g, g],
            [-g, g, -g],
            [-g, g, g],
            [g, -g, -g],
            [g, -g, g],
            [g, g, -g],
            [g, g, g],
        ]
    )
    wts = np.ones(8)
    return pts, wts


def _tri3_rule():
    # 1-pt centroid rule; weight carries the 0.5 local area (pyfem.py:68-80)
    return np.array([[1.0 / 3.0, 1.0 / 3.0]]), np.array([0.5])


def _tet5_rule():
    # 5-pt rule with the reference's normalization (weights sum to 1,
    # pyfem.py:115-134); see module docstring.
    pts = np.array(
        [
            [0.25, 0.25, 0.25],
            [0.5, 1.0 / 6.0, 1.0 / 6.0],
            [1.0 / 6.0, 0.5, 1.0 / 6.0],
            [1.0 / 6.0, 1.0 / 6.0, 0.5],
            [1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0],
        ]
    )
    wts = np.array([-0.8, 0.45, 0.45, 0.45, 0.45])
    return pts, wts


def _brick27_rule():
    # 3x3x3 Gauss, x fastest (pyfem.py:137-172). Exact tensor-product
    # weights (the reference hardcodes 10-digit truncations).
    p1, w1 = _gauss_legendre_3pt()
    return _tensor_rule(p1, w1, 3)


# ---------------------------------------------------------------------------
# Shape functions (local coordinates -> values / derivatives per node)
# ---------------------------------------------------------------------------


def _quad4_shape(pt):
    xi, eta = pt
    n = 0.25 * np.array(
        [
            (1 - xi) * (1 - eta),
            (1 + xi) * (1 - eta),
            (1 + xi) * (1 + eta),
            (1 - xi) * (1 + eta),
        ]
    )
    dn = 0.25 * np.array(
        [
            [-(1 - eta), -(1 - xi)],
            [(1 - eta), -(1 + xi)],
            [(1 + eta), (1 + xi)],
            [-(1 + eta), (1 - xi)],
        ]
    )
    return n, dn


_HEX8_SIGNS = np.array(
    [
        [-1, -1, -1],
        [1, -1, -1],
        [1, 1, -1],
        [-1, 1, -1],
        [-1, -1, 1],
        [1, -1, 1],
        [1, 1, 1],
        [-1, 1, 1],
    ],
    dtype=float,
)


def _hex8_shape(pt):
    s = _HEX8_SIGNS
    terms = 1.0 + s * np.asarray(pt)  # (8, 3)
    n = 0.125 * np.prod(terms, axis=1)
    dn = np.empty((8, 3))
    for d in range(3):
        others = [k for k in range(3) if k != d]
        dn[:, d] = 0.125 * s[:, d] * terms[:, others[0]] * terms[:, others[1]]
    return n, dn


def _tri3_shape(pt):
    l1, l2 = pt
    n = np.array([l1, l2, 1.0 - l1 - l2])
    dn = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]])
    return n, dn


def _tet10_shape(pt):
    xi, eta, zeta = pt
    t = np.array([1.0 - xi - eta - zeta, xi, eta, zeta])
    dt = np.array([[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    # Corner nodes: t_i (2 t_i - 1); edge nodes: 4 t_a t_b with the
    # reference's edge ordering (pyfem.py:380-445): (0,1),(1,2),(2,0),
    # (0,3),(1,3),(2,3).
    edges = [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)]
    n = np.empty(10)
    dn = np.empty((10, 3))
    n[:4] = t * (2.0 * t - 1.0)
    dn[:4] = (4.0 * t - 1.0)[:, None] * dt
    for e, (a, b) in enumerate(edges):
        n[4 + e] = 4.0 * t[a] * t[b]
        dn[4 + e] = 4.0 * (t[a] * dt[b] + t[b] * dt[a])
    return n, dn


_BRICK20_COORDS = np.array(
    [
        # 8 corners
        [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        # 12 mid-edge nodes (pyfem.py:460-482 ordering)
        [0, -1, -1], [1, 0, -1], [0, 1, -1], [-1, 0, -1],
        [0, -1, 1], [1, 0, 1], [0, 1, 1], [-1, 0, 1],
        [-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0],
    ],
    dtype=float,
)


def _brick20_shape(pt):
    """Quadratic serendipity brick (Zienkiewicz 6th ed., p. 121)."""
    pt = np.asarray(pt, dtype=float)
    c = _BRICK20_COORDS
    n = np.empty(20)
    dn = np.empty((20, 3))
    # Corner nodes: 1/8 (1+xi xi_i)(1+eta eta_i)(1+zeta zeta_i)(sum - 2)
    for i in range(8):
        terms = 1.0 + c[i] * pt  # (3,)
        s = float(np.dot(c[i], pt))
        n[i] = 0.125 * terms.prod() * (s - 2.0)
        for d in range(3):
            o = [k for k in range(3) if k != d]
            dn[i, d] = (
                0.125
                * c[i, d]
                * terms[o[0]]
                * terms[o[1]]
                * (s + c[i, d] * pt[d] - 1.0)
            )
    # Mid-edge nodes: 1/4 (1-a^2)(1+b b_i)(1+c c_i) where a is the axis
    # with zero nodal coordinate.
    for i in range(8, 20):
        z = int(np.argmin(np.abs(c[i])))  # the zero axis
        o = [k for k in range(3) if k != z]
        quad = 1.0 - pt[z] ** 2
        t0 = 1.0 + c[i, o[0]] * pt[o[0]]
        t1 = 1.0 + c[i, o[1]] * pt[o[1]]
        n[i] = 0.25 * quad * t0 * t1
        dn[i, z] = -0.5 * pt[z] * t0 * t1
        dn[i, o[0]] = 0.25 * quad * c[i, o[0]] * t1
        dn[i, o[1]] = 0.25 * quad * t0 * c[i, o[1]]
    return n, dn


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def _tet10_node_coords():
    corners = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float
    )
    edges = [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)]
    mids = np.array([(corners[a] + corners[b]) / 2 for a, b in edges])
    return np.vstack([corners, mids])


_NODE_COORDS = {
    "quad4": np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=float),
    "tri3": np.array([[1, 0], [0, 1], [0, 0]], dtype=float),
    "hex8": _HEX8_SIGNS,
    "tet10": _tet10_node_coords(),
    "brick20": _BRICK20_COORDS,
}


def _tabulate(name, ndims, nnodes, rule_fn, shape_fn) -> ElementType:
    pts, wts = rule_fn()
    nq = pts.shape[0]
    vals = np.zeros((nq, nnodes))
    grads = np.zeros((nq, nnodes, ndims))
    for q in range(nq):
        vals[q], grads[q] = shape_fn(pts[q])
    return ElementType(
        name=name,
        ndims=ndims,
        nnodes=nnodes,
        quad_pts=pts,
        quad_wts=wts,
        shape_vals=vals,
        shape_grads=grads,
        node_coords=_NODE_COORDS[name],
    )


ELEMENT_REGISTRY: dict[str, ElementType] = {}

_ALIASES = {
    "quad": "quad4",
    "tri": "tri3",
    "block": "hex8",
    "tet": "tet10",
    "brick": "brick20",
    # Abaqus element codes (parse_inp.py:20-36)
    "CPS3": "tri3",
    "C3D8R": "hex8",
    "C3D10": "tet10",
}


def register_element(etype: ElementType) -> ElementType:
    ELEMENT_REGISTRY[etype.name] = etype
    return etype


register_element(_tabulate("quad4", 2, 4, _quad4_rule, _quad4_shape))
register_element(_tabulate("tri3", 2, 3, _tri3_rule, _tri3_shape))
register_element(_tabulate("hex8", 3, 8, _hex8_rule, _hex8_shape))
register_element(_tabulate("tet10", 3, 10, _tet5_rule, _tet10_shape))
register_element(_tabulate("brick20", 3, 20, _brick27_rule, _brick20_shape))


def get_element(name) -> ElementType:
    """Look up an element type by canonical name or alias."""
    if isinstance(name, ElementType):
        return name
    key = _ALIASES.get(name, name)
    if key not in ELEMENT_REGISTRY:
        raise KeyError(
            f"unknown element type {name!r}; known: "
            f"{sorted(ELEMENT_REGISTRY) + sorted(_ALIASES)}"
        )
    return ELEMENT_REGISTRY[key]
