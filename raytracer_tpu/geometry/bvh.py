"""BVH: host-side builder to flat arrays + array-encoded traversal.

Reference: /root/reference/internal/bvh.go:132-253 — a binary tree built
top-down with a *random* axis per node (bvh.go:147), sort-by-AABB-min and
median split (bvh.go:176-179), traversed recursively with the right child's
interval shrunk by the left hit (bvh.go:220-249).

Device-first redesign:
* The builder is deterministic (longest-axis median split — the reference's
  random axis only exists because Go's sort needed *a* comparator; hit
  results are identical for any valid BVH) and runs on host (NumPy) — scene
  build is a cold path (SURVEY.md §2.3). A C++ builder with the same array
  contract lives in cpp/ (native runtime tier); this NumPy one is the
  reference implementation and fallback.
* The tree is *array-encoded* for device traversal: per-node AABBs plus a
  stackless "skip link" (escape index): nodes are laid out in DFS preorder;
  a hit on the node's box advances to the next node (child), a miss jumps to
  `skip[i]`, so traversal is a single data-dependent loop with no stack —
  the standard GPU-friendly encoding.
* Leaves reference a contiguous range of a primitive permutation, so leaf
  primitives are tested with the same branchless sphere/quad math as the
  dense path.

The dense intersect (geometry/intersect.py) and its kernel form remain the
device path; `bvh_closest_hit` has no production caller yet. It is the
scaling path for large scenes (per-lane traversal on the GPU's SIMT lanes),
and the correctness oracle pins both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from raytracer_tpu.core import vecmath as vm
from raytracer_tpu.geometry.scene import Scene


class FlatBVH(NamedTuple):
    """Array-encoded BVH (device-resident)."""

    box_min: jnp.ndarray  # (M, 3) f32 node AABB min
    box_max: jnp.ndarray  # (M, 3) f32 node AABB max
    skip: jnp.ndarray  # (M,) i32 — node to jump to when this box misses
    leaf_start: jnp.ndarray  # (M,) i32 — first index into `prim_order`, -1 internal
    leaf_count: jnp.ndarray  # (M,) i32 — number of leaf primitives
    prim_order: jnp.ndarray  # (P,) i32 — permutation of global primitive ids


def primitive_bounds(scene: Scene) -> tuple[np.ndarray, np.ndarray]:
    """Host AABBs for all primitives (spheres then quads), matching the
    reference: sphere box = center ± r (hittables.go:86-92), quad box =
    corners with degenerate axes padded by 1e-4 (hittables.go:161,
    bvh.go:63-82). Dummy primitives get inverted boxes that never hit."""
    c = np.asarray(scene.sph_center, np.float64)
    r = np.abs(np.asarray(scene.sph_radius, np.float64))[:, None]
    smin = c - r
    smax = c + r
    dummy_s = np.asarray(scene.sph_radius) == 0.0
    smin[dummy_s] = np.inf
    smax[dummy_s] = -np.inf

    q = np.asarray(scene.quad_q, np.float64)
    u = np.asarray(scene.quad_u, np.float64)
    v = np.asarray(scene.quad_v, np.float64)
    corners = np.stack([q, q + u, q + v, q + u + v], axis=0)
    qmin = corners.min(axis=0)
    qmax = corners.max(axis=0)
    eps = 1e-4
    thin = (qmax - qmin) < eps
    qmin = np.where(thin, qmin - eps, qmin)
    qmax = np.where(thin, qmax + eps, qmax)
    dummy_q = (np.linalg.norm(np.cross(u, v), axis=-1) == 0.0)
    qmin[dummy_q] = np.inf
    qmax[dummy_q] = -np.inf

    return (
        np.concatenate([smin, qmin]).astype(np.float32),
        np.concatenate([smax, qmax]).astype(np.float32),
    )


def build_bvh(scene: Scene, leaf_size: int = 4, use_native: bool = True) -> FlatBVH:
    """Top-down longest-axis median-split build (host).

    Equivalent role to NewBVH (bvh.go:142-185); deterministic axis choice
    instead of rand.Intn(3) (bvh.go:147) — only hit results matter
    (SURVEY.md §3.5). Prefers the C++ builder (cpp/raytpu_native.cc, byte-
    identical output) and falls back to NumPy."""
    bmin, bmax = primitive_bounds(scene)
    if use_native:
        from raytracer_tpu import native

        out = native.build_bvh_native(bmin, bmax, leaf_size)
        if out is not None:
            bm, bx, sk, ls, lc, po = out
            return FlatBVH(
                box_min=jnp.asarray(bm),
                box_max=jnp.asarray(bx),
                skip=jnp.asarray(sk),
                leaf_start=jnp.asarray(ls),
                leaf_count=jnp.asarray(lc),
                prim_order=jnp.asarray(po),
            )
    valid = np.isfinite(bmin[:, 0])
    prims = np.flatnonzero(valid)
    if prims.size == 0:
        prims = np.array([0], np.int64)
    centers = (bmin[prims] + bmax[prims]) * 0.5

    nodes_min, nodes_max, skips, lstart, lcount = [], [], [], [], []
    order: list[int] = []

    def emit(ids) -> int:
        """DFS-preorder emit; returns node index."""
        idx = len(nodes_min)
        nodes_min.append(bmin[ids].min(axis=0))
        nodes_max.append(bmax[ids].max(axis=0))
        skips.append(-1)  # patched after subtree emitted
        if len(ids) <= leaf_size:
            lstart.append(len(order))
            lcount.append(len(ids))
            order.extend(int(i) for i in ids)
        else:
            lstart.append(-1)
            lcount.append(0)
            c = (bmin[ids] + bmax[ids]) * 0.5
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            mid = len(ids) // 2
            part = ids[np.argsort(c[:, axis], kind="stable")]
            emit(part[:mid])
            emit(part[mid:])
        skips[idx] = len(nodes_min)  # next node after this subtree
        return idx

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        emit(prims)
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        box_min=jnp.asarray(np.array(nodes_min, np.float32)),
        box_max=jnp.asarray(np.array(nodes_max, np.float32)),
        skip=jnp.asarray(np.array(skips, np.int32)),
        leaf_start=jnp.asarray(np.array(lstart, np.int32)),
        leaf_count=jnp.asarray(np.array(lcount, np.int32)),
        prim_order=jnp.asarray(np.array(order, np.int32)),
    )


def _slab_test(box_min, box_max, o, inv_d, t_min, t_max):
    """Branchless slab test (reference Aabb.Hit / InBoundary, bvh.go:52-102,
    strict `rT.min < rT.max`)."""
    t0 = (box_min - o) * inv_d
    t1 = (box_max - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    tn = jnp.maximum(t_min, jnp.max(lo, axis=-1))
    tf = jnp.minimum(t_max, jnp.min(hi, axis=-1))
    return tn < tf


def bvh_closest_hit(scene: Scene, bvh: FlatBVH, origin, direction, t_min=1e-3):
    """Closest hit via stackless skip-link traversal, vmapped over rays.

    Returns (t (N,), prim (N,) i32) with the same semantics as the dense
    search. Per-ray `lax.while_loop` — correct and memory-lean, but lanes
    diverge; used for large scenes / as the oracle cross-check
    (tests/test_bvh.py), not the default hot path.
    """
    from raytracer_tpu.geometry.intersect import quad_derived

    ns = scene.num_spheres
    num_nodes = bvh.box_min.shape[0]
    qd = quad_derived(scene)
    max_leaf = int(np.max(np.asarray(bvh.leaf_count))) if num_nodes else 0

    def one_ray(o, d):
        # Sign-preserving tiny nudge on zero direction components: 1/0 = inf
        # and (box-o)*inf with o ON the plane is 0*inf = NaN, whose
        # comparisons read as miss. Keep the slab test conservative.
        tiny = 1e-30
        safe_d = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
        inv_d = 1.0 / safe_d

        def prim_t(p):
            """Candidate t for global primitive id p (sphere or quad)."""
            is_quad = p >= ns
            si = jnp.minimum(p, ns - 1)
            qi = jnp.clip(p - ns, 0, scene.num_quads - 1)
            # Sphere (hittables.go:96-116)
            c = scene.sph_center[si]
            r = scene.sph_radius[si]
            oc = o - c
            a = vm.dot(d, d)
            half_b = vm.dot(d, oc)
            cc = vm.dot(oc, oc) - r * r
            disc = half_b * half_b - a * cc
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            ts0 = (-half_b - sq) / a
            ts1 = (-half_b + sq) / a
            # Strict disc > 0, matching the dense oracle path
            # (_sphere_candidate_t): exactly-tangent rays miss in both.
            feas = (disc > 0.0) & (r != 0.0)
            ts0 = jnp.where(feas & (ts0 > t_min), ts0, jnp.inf)
            ts1 = jnp.where(feas & (ts1 > t_min), ts1, jnp.inf)
            t_s = jnp.minimum(ts0, ts1)
            # Quad (hittables.go:167-194)
            nrm = qd.normal[qi]
            dn = vm.dot(d, nrm)
            ok = jnp.abs(dn) >= 1e-8
            tq = (qd.d[qi] - vm.dot(o, nrm)) / jnp.where(ok, dn, 1.0)
            pt = o + tq * d
            alpha = vm.dot(pt, qd.av[qi]) - qd.q_av[qi]
            beta = vm.dot(pt, qd.bv[qi]) - qd.q_bv[qi]
            okq = (
                ok
                & (tq > t_min)
                & (alpha >= 0)
                & (alpha <= 1)
                & (beta >= 0)
                & (beta <= 1)
            )
            t_q = jnp.where(okq, tq, jnp.inf)
            return jnp.where(is_quad, t_q, t_s)

        def cond(state):
            node, _, _ = state
            return node < num_nodes

        def body(state):
            node, t_best, p_best = state
            hit_box = _slab_test(
                bvh.box_min[node], bvh.box_max[node], o, inv_d, t_min, t_best
            )
            is_leaf = bvh.leaf_start[node] >= 0

            def test_leaf(carry):
                t_b, p_b = carry
                start = bvh.leaf_start[node]
                cnt = bvh.leaf_count[node]

                def leaf_body(j, c):
                    t_b, p_b = c
                    p = bvh.prim_order[start + j]
                    tc = jnp.where(j < cnt, prim_t(p), jnp.inf)
                    better = tc < t_b
                    return jnp.where(better, tc, t_b), jnp.where(better, p, p_b)

                return jax.lax.fori_loop(0, max_leaf, leaf_body, (t_b, p_b))

            t_best, p_best = jax.lax.cond(
                hit_box & is_leaf, test_leaf, lambda c: c, (t_best, p_best)
            )
            # Hit internal node -> descend (next in preorder); miss -> skip.
            node = jnp.where(hit_box, node + 1, bvh.skip[node])
            return node, t_best, p_best

        _, t_best, p_best = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.float32(jnp.inf), jnp.int32(-1))
        )
        return t_best, p_best

    return jax.vmap(one_ray)(origin, direction)
