"""Sequence packing / balancing (port of ``areal_tpu/base/datapack.py``).

A copy of the reference's pure-Python paths that the trainer's
micro-batch split and packing call: given per-sequence token counts,
first-fit-decreasing allocation and bin packing under a token budget,
and the order-preserving balanced partition.  The reference's native C
fast path (``_native``) is not ported; the Python paths give the same
groups and bins.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def flat2d(xs: Sequence[Sequence]) -> List:
    """Flatten one nesting level."""
    return [x for sub in xs for x in sub]


def partition_balanced(nums: Sequence[int], k: int) -> List[List[int]]:
    """Partition indices 0..n-1 (order preserving, contiguous) into exactly
    ``k`` non-empty groups minimizing the maximum group sum (linear-partition
    DP, O(n^2 k))."""
    n = len(nums)
    if k > n:
        raise ValueError(f"cannot partition {n} items into {k} non-empty groups")
    if k == 1:
        return [list(range(n))]
    prefix = np.concatenate([[0], np.cumsum(nums)])
    INF = float("inf")
    # dp[j][i]: minimal max-sum partitioning first i items into j groups
    dp = np.full((k + 1, n + 1), INF)
    cut = np.zeros((k + 1, n + 1), dtype=int)
    dp[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n + 1):
            # last group = items t..i-1
            for t in range(j - 1, i):
                cost = max(dp[j - 1][t], prefix[i] - prefix[t])
                if cost < dp[j][i]:
                    dp[j][i] = cost
                    cut[j][i] = t
    groups: List[List[int]] = []
    i = n
    for j in range(k, 0, -1):
        t = cut[j][i]
        groups.append(list(range(t, i)))
        i = t
    groups.reverse()
    return groups


def ffd_allocate(
    nums: Sequence[int], capacity: int, min_groups: int = 1
) -> List[List[int]]:
    """First-fit-decreasing allocation with a minimum group count: groups
    of total <= capacity when possible, and at least ``min_groups`` of them
    (falling back to a longest-processing-time balance into exactly
    ``min_groups`` bins)."""
    if min_groups > len(nums):
        raise ValueError(
            f"cannot allocate {len(nums)} items into {min_groups} groups"
        )
    bins = bin_pack_ffd(nums, capacity)
    if len(bins) >= min_groups:
        return bins
    order = np.argsort(nums)[::-1]
    groups: List[List[int]] = [[] for _ in range(min_groups)]
    sums = np.zeros(min_groups)
    for i in order:
        b = int(np.argmin(sums))
        groups[b].append(int(i))
        sums[b] += nums[i]
    return [g for g in groups if g]


def bin_pack_ffd(nums: Sequence[int], capacity: int) -> List[List[int]]:
    """First-fit-decreasing bin packing (non-contiguous).  Deterministic:
    the decreasing order is a reversed stable ascending sort (ties break by
    descending original index), and first fit scans bins in creation
    order."""
    order = np.argsort(nums, kind="stable")[::-1]
    bins: List[List[int]] = []
    sums: List[int] = []
    for i in order:
        x = nums[i]
        for b in range(len(bins)):
            if sums[b] + x <= capacity:
                bins[b].append(int(i))
                sums[b] += x
                break
        else:
            bins.append([int(i)])
            sums.append(int(x))
    return bins
