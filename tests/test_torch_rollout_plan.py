"""The rollout plan (which kernel, cluster size, row tile and shared memory a
rollout gets on the card) and the cluster kernel's decomposition, on the CPU.

The plan is pure Python and chosen from shapes alone.  The cluster kernel
(``csrc/mlp_resnet_rollout_cluster.cu``) splits the hidden columns over the
CTAs of a cluster and sums the partial residuals in rank order; a slice-wise
plain rollout that does the same, zero padding and empty slices included, is
held against ``mlp_resnet_rollout_reference`` here.  The kernel itself runs
on the card only (``chip_smoke.py``).

Tolerance: atol 1e-5, as in ``test_torch_rollout.py``.  Both sides are f32;
the slice-wise rollout sums each product in another order.
"""

import numpy as np
import pytest
import torch

from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet
from spatiotemporal_variable_separation_tpu_torch.ops.rollout import (
    CLUSTER_SIZES,
    SMEM_LIMIT,
    cluster_smem_bytes,
    mlp_resnet_rollout,
    mlp_resnet_rollout_reference,
    pack_w2,
    rollout_plan,
    stream_layout,
    stream_smem_bytes,
)

ATOL = 1e-5

PLANS = [  # batch, code, hidden, n_blocks -> variant, cluster
    pytest.param(64, 20, 512, 1, "cluster", 8, id="serving"),
    pytest.param(13, 20, 512, 2, "cluster", 16, id="2-blocks-H512"),
    pytest.param(64, 20, 512, 4, "stream", 16, id="4-blocks-H512"),
    pytest.param(32, 20, 64, 1, "cluster", 1, id="H64"),
    pytest.param(13, 20, 516, 1, "cluster", 8, id="H516-ragged-slice"),
]


@pytest.mark.parametrize("batch,code,hidden,n_blocks,variant,cluster", PLANS)
def test_plan_chooses_the_smallest_cluster_that_fits(batch, code, hidden, n_blocks,
                                                     variant, cluster):
    plan = rollout_plan(batch, code, hidden, n_blocks)
    assert (plan.variant, plan.cluster) == (variant, cluster)
    assert plan.grid * plan.rows >= batch
    if variant == "cluster":
        assert plan.smem_bytes <= SMEM_LIMIT
        assert plan.smem_bytes == cluster_smem_bytes(code, hidden, n_blocks, cluster,
                                                     plan.rows)
        assert plan.grid % plan.cluster == 0
        assert plan.grid // plan.cluster == -(-batch // plan.rows)
    smaller = [c for c in CLUSTER_SIZES if c < plan.cluster or variant == "stream"]
    for c in smaller:
        assert cluster_smem_bytes(code, hidden, n_blocks, c, plan.rows) > SMEM_LIMIT


def test_plan_ragged_hidden_slice():
    plan = rollout_plan(13, 20, 516, 1)
    width = -(-516 // plan.cluster)
    assert 516 % plan.cluster and 516 - (plan.cluster - 1) * width == 61


def test_serving_plan_shared_memory_by_hand():
    # Per CTA at C 8, R 8: W1 and W3 slices 20*64 each, biases 2*64 + 20, W2
    # slice 512*64; activations t 20*8, h1 512*8, h2 64*8, the split-K scratch
    # of W2 (8 groups of 64 columns) 8*64*8 and the partials 8*20*8 floats.
    floats = 2 * 20 * 64 + 2 * 64 + 20 + 512 * 64 + 8 * (20 + 512 + 64 + 8 * 64 + 8 * 20)
    assert cluster_smem_bytes(20, 512, 1, 8, 8) == 4 * floats == 182_480


@pytest.mark.parametrize("batch", [1, 7, 64, 65, 1000])
@pytest.mark.parametrize("rows", [4, 8])
def test_cluster_grid_is_whole_clusters(batch, rows):
    plan = rollout_plan(batch, 20, 512, 1, variant="cluster", rows=rows)
    assert plan.rows == rows and plan.grid == -(-batch // rows) * plan.cluster
    assert plan.smem_bytes <= SMEM_LIMIT


def test_forced_stream_plan():
    # 6 clusters of 16 CTAs at 12 rows: one wave where 7 fit at once, and the
    # least work a CTA of any one-wave plan (12 rows x 32 columns).
    plan = rollout_plan(64, 20, 512, 1, variant="stream")
    assert plan == ("stream", 16, 12, stream_smem_bytes(20, 512, 1, 16, 12), 96, 1, True)


@pytest.mark.parametrize("kwargs,match", [
    (dict(n_blocks=17), "1 to 16 blocks"),
    (dict(n_blocks=0), "1 to 16 blocks"),
    (dict(n_blocks=4, variant="cluster"), "no cluster"),
    (dict(variant="tensor"), "variant must be"),
    (dict(rows=5), "4 or 8 rows"),
    (dict(variant="stream", rows=6), "streaming kernel takes 4 to 32 rows"),
    (dict(hidden=8200), r"no rollout kernel takes 1 block\(s\) at code 20, hidden 8200"),
])
def test_plan_rejects(kwargs, match):
    args = dict(batch=64, code=20, hidden=512, n_blocks=1)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        rollout_plan(**args)


def sliced_rollout(t0, params, n_steps, cluster, stream=False, rows=None):
    """The cluster kernels' arithmetic in PyTorch: rank j holds hidden columns
    [j*S, j*S + S) clipped to hidden (S = ceil(hidden / cluster)), padded with
    zero weights to a multiple of 4; h1 is gathered from every rank's real
    columns; the partial residuals are summed in rank order 0..C-1.

    ``stream=True`` takes the streaming kernel's W2 product: each rank's W2
    slice as ``pack_w2`` lays it out, cut into chunks of ``chunk_rows`` rows;
    thread group g sums its 16 rows of every chunk in stream order, and the
    groups' sums meet in order g = 0, 1, ....  ``rows`` runs the batch in
    tiles of that many rows, the ragged last one padded with zero rows."""
    hidden = params[0].shape[1]
    s = -(-hidden // cluster)
    sp = -(-s // 4) * 4
    slices = []
    for j in range(cluster):
        lo = min(hidden, j * s)
        slices.append((lo, min(hidden, lo + s) - lo))
    if rows is not None:
        pad = -t0.shape[0] % rows
        return sliced_rollout(torch.cat([t0, t0.new_zeros(pad, t0.shape[1])]), params,
                              n_steps, cluster, stream)[:, :t0.shape[0]]
    if stream:
        lay = stream_layout(hidden, cluster)
        packed = pack_w2(params, cluster)
        group_rows = lay.chunk_rows // lay.k_groups

    def pad(w, lo, width, dim):  # the rank's columns (dim 1) or rows (dim 0), zero-padded to sp
        piece = w.narrow(dim, lo, width)
        shape = list(piece.shape)
        shape[dim] = sp - width
        return torch.cat([piece, torch.zeros(shape)], dim=dim)

    def w2_product(h1, w2, b, j, lo, width):
        if not stream:
            return h1 @ pad(w2, lo, width, 1)
        h1 = torch.cat([h1, h1.new_zeros(h1.shape[0], lay.hidden_pad - hidden)], dim=1)
        groups = []
        for g in range(lay.k_groups):
            acc = torch.zeros(h1.shape[0], sp)
            for c in range(lay.n_chunks):  # stream order
                k0 = c * lay.chunk_rows + g * group_rows
                acc = acc + h1[:, k0:k0 + group_rows] @ packed[b, j, k0:k0 + group_rows]
            groups.append(acc)
        total = groups[0]
        for acc in groups[1:]:
            total = total + acc
        return total

    t, out = t0, [t0]
    for _ in range(n_steps - 1):
        for i in range(0, len(params), 6):
            w1, b1, w2, b2, w3, b3 = params[i:i + 6]
            h1 = torch.cat([torch.relu(t @ w1[:, lo:lo + w] + b1[lo:lo + w])
                            for lo, w in slices], dim=1)
            assert h1.shape[1] == hidden
            total = None
            for j, (lo, w) in enumerate(slices):
                h2 = torch.relu(w2_product(h1, w2, i // 6, j, lo, w) + pad(b2[None], lo, w, 1))
                part = h2 @ pad(w3, lo, w, 0)
                total = part if total is None else total + part
            t = t + (total + b3)
        out.append(t)
    return torch.stack(out)


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("hidden,n_blocks", [(32, 2), (36, 1)])
def test_sliced_rollout_matches_reference(cluster, hidden, n_blocks):
    # hidden 36 over 8 ranks leaves a 1-column last slice; over 16, empty ones.
    gen = torch.Generator().manual_seed(3)
    params = MLPResnet(8, n_blocks, hidden, generator=gen).flat_params()
    t0 = torch.from_numpy(np.random.default_rng(cluster).random((5, 8), dtype=np.float32))
    with torch.no_grad():
        ref = mlp_resnet_rollout_reference(t0, params, 6)
        ours = sliced_rollout(t0, params, 6, cluster)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("variant", ["cluster", "stream"])
def test_cpu_takes_the_plain_version_whatever_the_plan(variant):
    gen = torch.Generator().manual_seed(4)
    params = MLPResnet(8, 1, 32, generator=gen).flat_params()
    t0 = torch.rand(3, 8, generator=gen)
    plan = rollout_plan(3, 8, 32, 1, variant=variant)
    before = (mlp_resnet_rollout.launches, dict(mlp_resnet_rollout.variant_launches))
    with torch.no_grad():
        out = mlp_resnet_rollout(t0, params, 4, plan=plan)
        ref = mlp_resnet_rollout_reference(t0, params, 4)
    assert (mlp_resnet_rollout.launches, mlp_resnet_rollout.variant_launches) == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
