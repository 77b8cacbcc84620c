"""The launch plans of the sweep and combine kernels (`sweep_plan`,
`combine_plan` in ops/kernels/wavefront_kernel.py), checked here on the
CPU for every Lp each kernel takes: the blocks of a pair own the lanes
1..Lp with no gap and no lane twice, a cluster has at most 16 blocks, a
block stays within the H100's 232,448 bytes of shared memory and its
instance's threads, and the instances up to 8,192 (sweep) and 4,096
(combine) lanes launch as they did before the cluster instances.  The
launchers in csrc/ refuse a plan whose shared bytes differ from their own
layout; the card tests (tests/test_torch_kernels.py) launch at every edge
of these plans.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as twk  # noqa: E402
from mlprobs_tpu_torch.ops.kernels.build import KernelArgumentError  # noqa: E402

SMEM = 232448


def _sweep_short_plan(lp):
    # the short instance's launch as csrc/sweep.cu computes it
    # (`short_plan`): 4 lanes a thread, 1,024 lanes a block at most
    cl = max(1, -(-lp // 1024))
    per = -(-lp // cl)
    nt = max(32, -(-(-(-per // 4)) // 32) * 32)
    return cl, nt


def _combine_one_block_plan(lp):
    # the one-block instance's launch as csrc/combine.cu computed it before
    # the cluster instance: 16 lanes a thread, a ring of 2 to 16 rows, two
    # blocks an SM where they fit, no more producers than rows
    g = max(1, -(-lp // 512))

    def smem(r):
        return r * (g * 512 + 4) * 4 + 16 * r + 128 + 2048

    def depth(budget):
        r = 16
        while r > 2 and smem(r) > budget:
            r -= 1
        return r

    half = 233472 // 2 - 1024
    r = depth(half)
    if smem(r) > half:
        r = depth(SMEM)
    return g, min(7 if g == 1 else 8, r), r, smem(r)


def _owners(span, blocks, lpt, lp):
    """Each lane 1..lp's count of (block, thread, slot) owners."""
    lane = (1 + np.arange(blocks)[:, None, None] * span
            + np.arange(span // lpt)[None, :, None] * lpt
            + np.arange(lpt)[None, None, :]).ravel()
    return np.bincount(lane[lane <= lp], minlength=lp + 1)[1:]


def test_sweep_plan_every_lp():
    """Every Lp from 0 to 49,152: one instance, the short one exactly as
    before up to 8,192 lanes; the blocks cover lanes 1..Lp in contiguous
    spans (none empty, none past the last needed); at most 8 blocks (short)
    or 16 (long) a cluster, 4 or 8 lanes a thread, whole warps, at most
    the instance's threads, shared memory within 232,448 bytes."""
    for lp in range(0, twk.SWEEP_MAX_LP + 1):
        p = twk.sweep_plan(lp)
        if lp < twk.SWEEP_LONG_FROM:
            assert (p.instance, p.lpt, p.maxt) == (0, 4, 256)
            assert (p.blocks, p.threads) == _sweep_short_plan(lp)
            assert p.blocks <= 8
        else:
            assert p.instance == 1 and p.blocks <= twk.MAX_CLUSTER
            assert (p.lpt, p.maxt) in ((4, 256), (8, 256), (8, 384))
        assert p.threads % 32 == 0 and 32 <= p.threads <= p.maxt
        assert p.span == p.threads * p.lpt
        assert p.blocks * p.span >= lp
        assert lp == 0 or (p.blocks - 1) * p.span < lp
        assert p.smem <= SMEM


@pytest.mark.parametrize("lp", [1, 4, 5, 1024, 1025, 8192, 8193, 9217,
                                16384, 16385, 32769, 49152])
def test_sweep_plan_owns_each_lane_once(lp):
    """Lane by lane at the instances' edges: each of 1..Lp has exactly one
    (block, thread, slot); lane 0 rides in thread 0 of block 0."""
    p = twk.sweep_plan(lp)
    assert (_owners(p.span, p.blocks, p.lpt, lp) == 1).all()


def test_combine_plan_every_lp():
    """Every Lp from 0 to 65,536: the one-block instance exactly as before
    up to 4,096 lanes; past it a cluster whose blocks' DP spans cover
    lanes 1..Lp (none empty), at most 16 blocks of at most 8 DP warps, 4,
    8 or 16 lanes a thread, no more producers than ring rows, at most 512
    threads (384 at 16 lanes a thread), shared memory within 232,448
    bytes, and a top-k list of min(k, span + 1) entries a block."""
    for lp in range(0, twk.COMBINE_MAX_LP + 1):
        p = twk.combine_plan(lp, 16)
        if lp < twk.COMBINE_CLUSTER_FROM:
            assert (p.instance, p.lpt, p.blocks, p.list_len) == (0, 16, 1, 0)
            assert (p.dp_warps, p.producers, p.rows, p.smem) == \
                _combine_one_block_plan(lp)
        else:
            assert p.instance == 1 and 2 <= p.blocks <= twk.MAX_CLUSTER
            assert p.lpt in (4, 8, 16)
            assert p.list_len == min(16, p.span + 1)
            assert 32 * (p.dp_warps + p.producers) <= (
                384 if p.lpt == 16 else 512)
        assert 1 <= p.dp_warps <= 8 and 1 <= p.producers <= p.rows <= 16
        assert p.blocks * p.span >= lp
        assert lp == 0 or (p.blocks - 1) * p.span < lp
        assert p.smem <= SMEM


@pytest.mark.parametrize("lp", [1, 512, 513, 4096, 4097, 6145, 8320, 16385,
                                32769, 65536])
def test_combine_plan_owns_each_lane_once(lp):
    """Lane by lane at the instances' edges: each of 1..Lp has exactly one
    (block, DP thread, slot); the top-k list of a block holds at most k
    entries and at most its lanes (lane 0 too in the GIVEN kind)."""
    for k in (0, 1, 16, lp + 1):
        p = twk.combine_plan(lp, k)
        assert (_owners(p.span, p.blocks, p.lpt, lp) == 1).all()
        if p.blocks > 1:
            assert p.list_len == min(k, p.span + 1)


def test_plans_refuse_lengths_past_the_kernels():
    """Past the most lanes each kernel takes (and below 0) the plan
    raises KernelArgumentError, before any launch."""
    for bad in (-1, twk.SWEEP_MAX_LP + 1):
        with pytest.raises(KernelArgumentError):
            twk.sweep_plan(bad)
    for bad in (-1, twk.COMBINE_MAX_LP + 1):
        with pytest.raises(KernelArgumentError):
            twk.combine_plan(bad, 16)
    # at least what the parent's instances took: the sweep's 32 lanes a
    # thread to 44,900 (its x row in shared memory), combine's tiles past
    # 53,248
    assert twk.SWEEP_MAX_LP >= 44900 and twk.COMBINE_MAX_LP >= 57344
