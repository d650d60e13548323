"""Data and tensor parallelism: meshes, process groups, kernel sharding
(torch counterpart of the JAX package's ``parallel/``)."""

from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
from spatiotemporal_variable_separation_tpu_torch.parallel.tensor import (  # noqa: F401
    kernel_partition_spec,
    model_axis_size,
    shard_state,
    state_shardings,
)
