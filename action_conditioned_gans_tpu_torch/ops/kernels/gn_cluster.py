"""The plan of the GroupNorm cluster kernels, in Python.

A copy of ``csrc/gn_cluster.cuh``'s ``plan_at``, ``choose_plan`` (kernel 3,
``norm_act.gn_plan``, the forward) and ``fit_plan`` (kernel 4,
``gn_bwd.gn_bwd_plan``, the backward). One thread-block cluster
per sample; each block holds a contiguous share of the sample's rows and
keeps as many of them in shared memory as fit. A kernel describes what it
keeps by the bytes of one row of its kept arrays, its unit width and its
shared memory past the kept rows; the plan gives the cluster size, the rows
of the largest share, the rows kept, the shared memory a block and the
bytes of one sample read twice.
"""

from __future__ import annotations

from typing import NamedTuple

# csrc/gn_cluster.cuh: threads per block, a block's dynamic shared memory on
# sm_90, the largest portable cluster, the largest cluster the plans take
# (non-portable), the blocks kernel 3's plan aims for, the H100's SMs, the
# most shared memory at which two blocks share an SM.
NT, SMEM_MAX, PORTABLE_CLUSTER, MAX_CLUSTER = 256, 232448, 8, 16
FILL_BLOCKS, SMS, TWO_PER_SM = 256, 132, 115200


class GnPlan(NamedTuple):
    cluster: int  # blocks per sample: one thread-block cluster
    rows_max: int  # rows of the largest share, ceil(HW / cluster)
    keep_rows: int  # rows of its share a block keeps in shared memory
    vec: int  # channels per unit: 16 bytes' worth, or 1 when C is no multiple of that
    smem: int  # dynamic shared memory per block, bytes (< 0: no plan fits)
    reread: int  # bytes of one sample read twice (rows past keep_rows)


def share_rows(hw: int, cluster: int, rank: int) -> range:
    """The rows of the sample that block ``rank`` of the cluster holds."""
    return range(rank * hw // cluster, (rank + 1) * hw // cluster)


def align16(n: int) -> int:
    return -(-n // 16) * 16


def plan_at(row_bytes: int, vec: int, scratch: int, hw: int, cluster: int) -> GnPlan:
    """``gnc::plan_at``: the plan at ``cluster`` blocks a sample."""
    rows_max = -(-hw // cluster)
    room = SMEM_MAX - scratch
    keep = min(max(room, 0) // row_bytes, rows_max)
    smem = -1 if room < 0 else align16(keep * row_bytes) + scratch
    reread = sum(max(len(share_rows(hw, cluster, q)) - keep, 0) * row_bytes
                 for q in range(cluster))
    return GnPlan(cluster, rows_max, keep, vec, smem, reread)


def choose_plan(row_bytes: int, vec: int, scratch: int, b: int, hw: int) -> GnPlan:
    """``gnc::choose_plan``: the cluster doubles from 1 while it may (at most
    PORTABLE_CLUSTER blocks, each with a row) and either the grid has fewer
    than FILL_BLOCKS blocks or a share overflows a block. A cluster of 8 whose
    blocks each need an SM of their own (more shared memory than TWO_PER_SM)
    and that the card cannot hold at once for all b samples doubles once
    more, to 16."""
    k = 1
    while 2 * k <= PORTABLE_CLUSTER and 2 * k <= hw:
        p = plan_at(row_bytes, vec, scratch, hw, k)
        if b * k >= FILL_BLOCKS and p.keep_rows == p.rows_max:
            break
        k *= 2
    p = plan_at(row_bytes, vec, scratch, hw, k)
    if k == PORTABLE_CLUSTER and 2 * k <= hw and p.smem > TWO_PER_SM and b * k > SMS:
        return plan_at(row_bytes, vec, scratch, hw, 2 * k)
    return p


def fit_plan(row_bytes: int, vec: int, scratch: int, hw: int) -> GnPlan:
    """``gnc::fit_plan``: the smallest cluster (1, 2, 4, 8, then MAX_CLUSTER
    blocks, at most one a row) whose shares all fit a block's shared memory;
    where none does, the largest, with the rows that do not fit read twice."""
    k = 1
    while True:
        p = plan_at(row_bytes, vec, scratch, hw, k)
        if p.keep_rows == p.rows_max or 2 * k > MAX_CLUSTER or 2 * k > hw:
            return p
        k *= 2
