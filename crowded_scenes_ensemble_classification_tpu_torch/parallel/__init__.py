"""Parallel forms (JAX `parallel/__init__.py:1-33`): the device mesh
(`core.mesh`), the processes that share an ensemble's members and the sums
of a data-parallel step across them (`distributed`), streaming long-video
windows (`streaming`), time-sharded long clips with halo exchange for
inference (`temporal_halo`) and training (`halo_train`).  Data-parallel
training over a mesh is the train steps' `mesh=` (`train.engine`, on
`core.lockstep`)."""

from ..core.mesh import (  # noqa: F401
    data_parallel_mesh,
    ensemble_mesh,
    gather,
    make_mesh,
    shard_batch,
)
from .distributed import (  # noqa: F401
    ProcessSum,
    initialize_distributed,
    is_multi_process,
    my_member_assignments,
    shutdown_distributed,
)
from .halo_train import (  # noqa: F401
    halo_conv_bn_relu_train,
    make_time_sharded_convbn_train_step,
    update_running_stats,
)
from .streaming import (  # noqa: F401
    extract_windows,
    streaming_member_probabilities,
    streaming_predict,
    streaming_predict_batch,
    window_starts,
)
from .temporal_halo import (  # noqa: F401
    halo_conv3d,
    halo_exchange,
    halo_max_pool3d,
    shard_time,
    time_sharded_conv_stack,
    time_sharded_i3d_trunk,
)
