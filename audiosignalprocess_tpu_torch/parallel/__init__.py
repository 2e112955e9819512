"""Channel and time sharding on torch.distributed (the JAX package's
``parallel/``): a (channel, time) mesh of processes, halo exchange along
time, and the sharded whole-file operators."""

from audiosignalprocess_tpu_torch.parallel.halo import (  # noqa: F401
    halo_left,
    halo_right,
    send_right_add,
)
from audiosignalprocess_tpu_torch.parallel.launch import (  # noqa: F401
    initialize,
    spawn_local,
    warmup,
)
from audiosignalprocess_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_audio,
    make_mesh,
    shard_audio,
    shard_channels,
)
from audiosignalprocess_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_chain,
    sharded_fir,
    sharded_noise_gate,
    sharded_overlap_save,
    sharded_resample,
    sharded_time_stretch,
)
