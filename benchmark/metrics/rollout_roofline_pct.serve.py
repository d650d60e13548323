"""The rollout kernel's share of its roofline (%): the least time the card
could take for one rollout at the served shape, the larger of its operations
over the f32 peak and its bytes over the HBM rate (``rollout_cost``), over
the device time of one rollout: the time of the kernels whose name holds
``KERNEL`` (``csrc/mlp_resnet_rollout_cluster.cu``'s ``cluster_rollout_kernel``
and ``csrc/mlp_resnet_rollout.cu``'s ``stream_rollout_kernel``) over the
launches the port's own counter (``mlp_resnet_rollout.launches``) made in the
traced stretch."""

from reference.costs import rollout_cost

KERNEL = "rollout_kernel"


def read(view):
    launches = view.trace.counters.get("rollout_launches", 0)
    times = [e - s for _, s, e in view.trace.kernels(KERNEL)]
    if not times or not launches:
        return None
    c, mix = view.config, view.traffic
    ops, nbytes = rollout_cost(mix["batch"], c["code_size_t"], c["res_hidden_size"],
                               c["n_blocks"], mix["horizon"])
    bound_s = max(ops / view.peak_flops, nbytes / view.hbm_bytes_per_s)
    return 100.0 * bound_s / (sum(times) / launches / 1e9)
