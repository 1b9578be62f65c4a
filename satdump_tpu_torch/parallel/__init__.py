"""Scale-out layer: channel × time-block sharding of sample streams over
the ranks of a torch.distributed process group (parallel/timeshard.py)."""

from satdump_tpu_torch.parallel.timeshard import (  # noqa: F401
    Mesh,
    build_sharded_qpsk_step,
    device_count,
    make_mesh,
    run_sharded,
    set_virtual_devices,
    shard_input,
)
