"""The streaming rollout kernel's plan, layout, W2 packing and arithmetic, on
the CPU.

``csrc/mlp_resnet_rollout.cu`` splits the hidden columns over a cluster as
the cluster kernel does, keeps W1, the biases and W3 resident (or, where no
cluster holds those slices, reads them from L2), and streams each rank's W2
slice in chunks through a ring in shared memory.  What
surrounds the kernel is Python that runs here: the plan (cluster size, row
tile, waves, shared memory), ``stream_smem_bytes`` (the kernel's
``make_layout`` in Python; ``chip_smoke.py`` holds the two equal on the card)
and ``pack_w2``.  A plain emulation of the kernel's sums
(``sliced_rollout(..., stream=True)``) is held against
``mlp_resnet_rollout_reference``.  The kernel itself runs on the card only.

Tolerance: atol 1e-5, as in ``test_torch_rollout_plan.py``.  Both sides are
f32; the emulation sums each product in another order.
"""

import numpy as np
import pytest
import torch

from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet
from spatiotemporal_variable_separation_tpu_torch.ops.rollout import (
    CLUSTER_SIZES,
    H100_ACTIVE_CLUSTERS,
    SMEM_LIMIT,
    STREAM_ROWS,
    mlp_resnet_rollout_reference,
    pack_w2,
    rollout_plan,
    stream_layout,
    stream_smem_bytes,
)
from test_torch_rollout_plan import sliced_rollout

ATOL = 1e-5
WAVE = dict(batch=256, code=32, hidden=512, n_blocks=3)      # the f32 WaveEq eval
SERVING4 = dict(batch=64, code=20, hidden=512, n_blocks=4)   # the 4-block serving model


def fifteen_at_c8(cluster, rows, resident=True):
    """15 clusters of 8 fit at once (an H100 at one CTA an SM)."""
    return H100_ACTIVE_CLUSTERS[cluster]


@pytest.mark.parametrize("shape", [WAVE, SERVING4], ids=["wave", "serving-4-blocks"])
def test_stream_plan_is_one_wave(shape):
    assert rollout_plan(**shape).variant == "stream"  # no resident cluster holds it
    plan = rollout_plan(**shape, variant="stream", active_clusters=fifteen_at_c8)
    n_clusters = plan.grid // plan.cluster
    assert plan.waves == 1 and n_clusters <= fifteen_at_c8(plan.cluster, plan.rows)
    assert n_clusters * plan.rows >= shape["batch"] > (n_clusters - 1) * plan.rows
    assert plan.resident and plan.rows in STREAM_ROWS
    assert plan.smem_bytes == stream_smem_bytes(shape["code"], shape["hidden"],
                                                shape["n_blocks"], plan.cluster, plan.rows)
    assert plan.smem_bytes <= SMEM_LIMIT


def test_wave_plan_shared_memory_by_hand():
    # Per CTA at C 8, R 20, 2 stages (WaveEq: code 32, H 512, 3 blocks): resident
    # W1 and W3 slices 32*64 each and b1, b2 (64 each), b3 (32) for each of 3
    # blocks; 2 chunks of 128 W2 rows x 64 columns; activations t 32*20, h1
    # 512*20, h2 64*20, the split-K scratch (8 row groups of 64 columns)
    # 8*64*20 and the partials 8*32*20 floats; a full and an empty mbarrier of
    # 8 bytes for each of 2 slots and 8 row groups.
    floats = (3 * (2 * 32 * 64 + 2 * 64 + 32) + 2 * 128 * 64
              + 20 * (32 + 512 + 64 + 8 * 64 + 8 * 32) + 2 * 2 * 8 * 2)
    assert stream_smem_bytes(32, 512, 3, 8, 20) == 4 * floats == 226_944


@pytest.mark.parametrize("batch", [1, 13, 64, 250, 256, 1000])
@pytest.mark.parametrize("rows", [None, 4, 20])
def test_stream_grid_is_whole_clusters(batch, rows):
    plan = rollout_plan(batch, 32, 512, 3, variant="stream", rows=rows,
                        active_clusters=fifteen_at_c8)
    n_clusters = -(-batch // plan.rows)
    assert plan.grid == n_clusters * plan.cluster
    assert plan.waves == -(-n_clusters // fifteen_at_c8(plan.cluster, plan.rows))
    assert rows is None or plan.rows == rows
    assert plan.smem_bytes <= SMEM_LIMIT


def test_stream_plan_takes_fewest_waves_then_least_work():
    # Only clusters of 16 fit: the plan takes them whatever the work a CTA.
    only16 = rollout_plan(**WAVE, variant="stream",
                          active_clusters=lambda c, r, resident: 7 if c == 16 else 0)
    assert only16.cluster == 16 and only16.waves == -(-(-(-256 // only16.rows)) // 7)
    # Every launch fits at once: one wave and the least work a CTA (rows x
    # slice).
    plan = rollout_plan(**WAVE, variant="stream", active_clusters=lambda c, r, resident: 1000)
    assert plan.waves == 1
    work = plan.rows * stream_layout(512, plan.cluster).slice_pad
    for c in CLUSTER_SIZES:
        for r in STREAM_ROWS:
            if stream_smem_bytes(32, 512, 3, c, r) <= SMEM_LIMIT:
                assert r * stream_layout(512, c).slice_pad >= work
    # At 15 clusters of 8 and 7 of 16, 20 rows at C 8 are the one wave.
    assert rollout_plan(**WAVE, variant="stream")[1:3] == (8, 20)


@pytest.mark.parametrize("kwargs,match", [
    (dict(active_clusters=lambda c, r, resident: 0), "no rollout kernel takes 3 block"),
    (dict(hidden=8200), "no rollout kernel takes 3 block"),
    (dict(rows=36), "4 to 32 rows"),
    (dict(rows=6), "4 to 32 rows"),
])
def test_stream_plan_raises_when_nothing_fits(kwargs, match):
    args = dict(WAVE, variant="stream")
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        rollout_plan(**args)


L2_SHAPES = [dict(batch=64, code=64, hidden=512, n_blocks=8),
             dict(batch=50, code=20, hidden=2048, n_blocks=8),
             dict(batch=64, code=20, hidden=3600, n_blocks=16),
             dict(batch=256, code=128, hidden=1024, n_blocks=4)]


@pytest.mark.parametrize("shape", L2_SHAPES, ids=lambda s: "-".join(map(str, s.values())))
def test_stream_plan_reads_slices_from_l2_when_none_fit(shape):
    # No cluster size and row tile hold every block's W1, bias and W3 slices
    # beside the ring and the activations: the kernel reads them from L2.
    code, hidden, n_blocks = shape["code"], shape["hidden"], shape["n_blocks"]
    for c in CLUSTER_SIZES:
        if stream_layout(hidden, c).slice_pad <= 512:
            assert stream_smem_bytes(code, hidden, n_blocks, c, STREAM_ROWS[0]) > SMEM_LIMIT
    plan = rollout_plan(**shape)
    assert plan.variant == "stream" and not plan.resident
    assert plan.smem_bytes == stream_smem_bytes(code, hidden, n_blocks, plan.cluster, plan.rows,
                                                resident=False) <= SMEM_LIMIT
    assert plan.grid == -(-shape["batch"] // plan.rows) * plan.cluster
    assert plan.waves == -(-(plan.grid // plan.cluster) // H100_ACTIVE_CLUSTERS[plan.cluster])


def test_l2_plan_shared_memory_by_hand():
    # Per CTA at C 16, R 12 (code 64, H 512, 8 blocks): no resident slices; 2
    # chunks of 256 W2 rows x 32 columns; activations t 64*12, h1 512*12, h2
    # 32*12, the split-K scratch (16 row groups of 32 columns) 16*32*12 and the
    # partials 16*64*12 floats; 2 mbarriers of 8 bytes for each of 2 slots and
    # 16 row groups.
    floats = 2 * 256 * 32 + 12 * (64 + 512 + 32 + 16 * 32 + 16 * 64) + 2 * 2 * 16 * 2
    assert stream_smem_bytes(64, 512, 8, 16, 12, resident=False) == 4 * floats == 168_960
    assert rollout_plan(**L2_SHAPES[0])[1:4] == (16, 12, 168_960)


@pytest.mark.parametrize("code", [1, 10, 20, 32, 64, 128, 256, 512])
def test_stream_plan_takes_what_the_one_cta_kernel_took(code):
    # The earlier streaming kernel (one CTA per 8 rows, every weight read from
    # L2) took any block count at 8 * (code + 2 * hidden) floats of shared
    # memory; the cluster redesign takes every such shape up to code 512.
    top = (SMEM_LIMIT // 32 - code) // 2
    for hidden in sorted(set(range(1, top + 1, 29)) | set(range(top - 40, top + 1))):
        for n_blocks in (1, 16):
            plan = rollout_plan(64, code, hidden, n_blocks, variant="stream")
            assert plan.smem_bytes <= SMEM_LIMIT
            # Resident whenever some cluster size holds the slices at 4 rows.
            assert plan.resident == any(
                stream_smem_bytes(code, hidden, n_blocks, c, 4) <= SMEM_LIMIT
                for c in CLUSTER_SIZES if stream_layout(hidden, c).slice_pad <= 512)


@pytest.mark.parametrize("hidden,cluster", [(512, 8), (516, 8), (36, 16), (36, 8), (32, 1),
                                            (256, 16), (100, 4)])
def test_stream_layout_chunks_fit_a_bulk_copy(hidden, cluster):
    lay = stream_layout(hidden, cluster)
    assert lay.slice_pad % 4 == 0 and lay.slice_pad // 2 * lay.k_groups <= 256
    assert lay.hidden_pad == lay.n_chunks * lay.chunk_rows >= hidden
    assert lay.hidden_pad - hidden < lay.chunk_rows
    chunk_bytes = 4 * lay.chunk_rows * lay.slice_pad
    assert chunk_bytes % 16 == 0 and chunk_bytes < 2 ** 20  # cp.async.bulk, mbarrier tx


@pytest.mark.parametrize("hidden,cluster,n_blocks", [(512, 8, 3), (516, 8, 1), (36, 16, 2),
                                                     (36, 8, 1), (32, 1, 2)])
def test_pack_w2_equals_slicing_by_hand(hidden, cluster, n_blocks):
    # 516 over 8 leaves a 61-column last slice; 36 over 16 leaves empty ones.
    gen = torch.Generator().manual_seed(5)
    params = MLPResnet(8, n_blocks, hidden, generator=gen).flat_params()
    lay = stream_layout(hidden, cluster)
    packed = pack_w2(params, cluster)
    assert packed.shape == (n_blocks, cluster, lay.hidden_pad, lay.slice_pad)
    assert packed.is_contiguous() and packed.dtype == torch.float32
    for b in range(n_blocks):
        w2 = params[6 * b + 2].numpy()
        for j in range(cluster):
            lo = min(hidden, j * lay.slice)
            width = min(hidden, lo + lay.slice) - lo
            want = np.zeros((lay.hidden_pad, lay.slice_pad), np.float32)
            want[:hidden, :width] = w2[:, lo:lo + width]
            np.testing.assert_array_equal(packed[b, j].numpy(), want)


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("hidden,n_blocks", [(32, 1), (32, 3), (36, 2)])
def test_stream_arithmetic_matches_reference(cluster, hidden, n_blocks):
    # 7 rows in tiles of 4: a ragged last tile.  hidden 36 over 16 ranks
    # leaves empty slices and over 8 a 1-column one.  8 or 9 block-steps.
    gen = torch.Generator().manual_seed(6)
    params = MLPResnet(8, n_blocks, hidden, generator=gen).flat_params()
    t0 = torch.from_numpy(np.random.default_rng(cluster).random((7, 8), dtype=np.float32))
    n_steps = 1 + 8 // n_blocks
    with torch.no_grad():
        ref = mlp_resnet_rollout_reference(t0, params, n_steps)
        ours = sliced_rollout(t0, params, n_steps, cluster, stream=True, rows=4)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("hidden,cluster,n_chunks,hidden_pad", [(100, 1, 2, 160),
                                                               (200, 2, 3, 240)])
def test_stream_arithmetic_several_chunks(hidden, cluster, n_chunks, hidden_pad):
    # A slice of 100 columns: 50 column pairs leave 5 row groups of 16, chunks
    # of 80 rows, and a zero tail of 60 rows (hidden 100) or 40 (hidden 200).
    lay = stream_layout(hidden, cluster)
    assert (lay.n_chunks, lay.hidden_pad) == (n_chunks, hidden_pad)
    gen = torch.Generator().manual_seed(7)
    params = MLPResnet(8, 2, hidden, generator=gen).flat_params()
    t0 = torch.from_numpy(np.random.default_rng(0).random((5, 8), dtype=np.float32))
    with torch.no_grad():
        ref = mlp_resnet_rollout_reference(t0, params, 5)
        ours = sliced_rollout(t0, params, 5, cluster, stream=True, rows=8)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)
