"""The port's measurement tools, each run as ``python -m
spatiotemporal_variable_separation_tpu_torch.tools.<name>``: ``trace_flagship``
(the train step's buffer traffic and a profiler trace), ``bench_horizon_remat``
(the t+95 step with and without ``--remat``) and ``bench_serving_rollout``
(serving latency beside the rollout kernels)."""
