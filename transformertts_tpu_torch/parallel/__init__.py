from transformertts_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_shardings,
    make_mesh,
    param_spec,
    shard_batch,
    shard_state,
    state_shardings,
)
