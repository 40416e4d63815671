"""Point-bucketing hash grid.

JAX re-design of /root/reference/hashgrid.py:16-90 and the SPPM grid
(sppm.py:98-178).  The reference builds cell lists with scatter-reduce
collision-resolution loops (hashgrid.py:52-63) plus a prefix-sum over bin
counts; here one stable sort by cell id replaces the whole contention
machinery (SURVEY.md section 5 "race detection"): deterministic, no atomics,
O(N log N).

Layout: `order` lists point indices sorted by cell; `cell_start[c]/cell_end[c]`
delimit each cell's span.  Queries walk a fixed-size window of the span.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.struct import jstruct, static_field


def hash_cell(q, n_cells: int):
    """pbrt-v3 style LCG hash of integer cell coords (sppm.py:9-13)."""
    h = (
        (q[..., 0].astype(jnp.uint32) * jnp.uint32(73856093))
        ^ (q[..., 1].astype(jnp.uint32) * jnp.uint32(19349663))
        ^ (q[..., 2].astype(jnp.uint32) * jnp.uint32(83492791))
    )
    return (h % jnp.uint32(n_cells)).astype(jnp.int32)


@jstruct
class HashGrid:
    order: jnp.ndarray       # (N,) point indices sorted by cell
    point_cell: jnp.ndarray  # (N,) cell id per (unsorted) point
    cell_start: jnp.ndarray  # (C,) start offset into order
    cell_end: jnp.ndarray    # (C,)
    bbox_lo: jnp.ndarray     # (3,)
    inv_cell: jnp.ndarray    # () 1/cell_size
    n_cells: int = static_field(default=1)

    @staticmethod
    def build(points, cell_size, n_cells: int, bbox_lo=None):
        n = points.shape[0]
        if bbox_lo is None:
            bbox_lo = jnp.min(points, axis=0)
        inv = 1.0 / cell_size
        q = jnp.floor((points - bbox_lo) * inv).astype(jnp.int32)
        cell = hash_cell(q, n_cells)
        order = jnp.argsort(cell, stable=True).astype(jnp.int32)
        sorted_cell = jnp.take(cell, order)
        idx = jnp.arange(n + 1, dtype=jnp.int32)
        cell_start = jnp.searchsorted(
            sorted_cell, jnp.arange(n_cells, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        cell_end = jnp.searchsorted(
            sorted_cell, jnp.arange(n_cells, dtype=jnp.int32), side="right"
        ).astype(jnp.int32)
        return HashGrid(
            order=order,
            point_cell=cell,
            cell_start=cell_start,
            cell_end=cell_end,
            bbox_lo=bbox_lo,
            inv_cell=jnp.asarray(inv, m.Float),
            n_cells=n_cells,
        )

    @staticmethod
    def build_expanded(points, radius, cell_size, n_cells: int, bbox_lo=None):
        """Insert each point into every cell its radius-ball overlaps (the
        reference's expand_sample, sppm.py:34-96): the 8 corner cells of the
        ball's AABB, duplicates masked out so queries never double-count.
        Queries then only need the query point's own cell.

        Requires cell_size >= 2*max(radius): then the AABB spans at most two
        cells per axis and the 8 corners cover every overlapped cell.
        """
        n = points.shape[0]
        if bbox_lo is None:
            bbox_lo = jnp.min(points, axis=0) - cell_size
        inv = 1.0 / cell_size
        r = jnp.broadcast_to(jnp.asarray(radius, m.Float), (n,))[:, None]

        corners = []
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                for sz in (-1.0, 1.0):
                    off = jnp.asarray([sx, sy, sz], m.Float)
                    corners.append(
                        jnp.floor((points + off * r - bbox_lo) * inv).astype(
                            jnp.int32
                        )
                    )
        qs = jnp.stack(corners, axis=1)            # (N, 8, 3)
        # mask duplicate cells (keep first occurrence)
        keep = jnp.ones((n, 8), bool)
        for i in range(1, 8):
            dup = jnp.zeros((n,), bool)
            for j in range(i):
                dup |= jnp.all(qs[:, i] == qs[:, j], axis=-1) & keep[:, j]
            keep = keep.at[:, i].set(~dup)

        cell = hash_cell(qs.reshape(-1, 3), n_cells)
        cell = jnp.where(keep.reshape(-1), cell, n_cells)  # park dups in +inf bin
        point_idx = jnp.repeat(
            jnp.arange(n, dtype=jnp.int32), 8
        )
        order_e = jnp.argsort(cell, stable=True).astype(jnp.int32)
        sorted_cell = jnp.take(cell, order_e)
        cell_start = jnp.searchsorted(
            sorted_cell, jnp.arange(n_cells, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        cell_end = jnp.searchsorted(
            sorted_cell, jnp.arange(n_cells, dtype=jnp.int32), side="right"
        ).astype(jnp.int32)
        return HashGrid(
            order=jnp.take(point_idx, order_e),
            point_cell=hash_cell(
                jnp.floor((points - bbox_lo) * inv).astype(jnp.int32), n_cells
            ),
            cell_start=cell_start,
            cell_end=cell_end,
            bbox_lo=bbox_lo,
            inv_cell=jnp.asarray(inv, m.Float),
            n_cells=n_cells,
        )

    def cell_of(self, p):
        """hashgrid.py:86-90."""
        q = jnp.floor((p - self.bbox_lo) * self.inv_cell).astype(jnp.int32)
        return hash_cell(q, self.n_cells)

    def gather_neighbors(self, p, max_per_cell: int):
        """For query points p (M, 3): indices of up to `max_per_cell` points
        in the query's cell (padded with -1)."""
        c = self.cell_of(p)
        start = jnp.take(self.cell_start, c)
        end = jnp.take(self.cell_end, c)
        k = jnp.arange(max_per_cell, dtype=jnp.int32)
        slots = start[:, None] + k[None, :]
        valid = slots < end[:, None]
        idx = jnp.take(self.order, jnp.minimum(slots, self.order.shape[0] - 1))
        return jnp.where(valid, idx, -1)
