"""Multi-device scale-out: the tuple graph over a grid of devices
(counterpart of ``keto_tpu/parallel/``).

The reference scales out with ``jax.sharding`` and ``shard_map`` over an
ICI mesh. The port keeps its layout and drives a ``[data, edge]`` grid of
``torch.device``\\ s from one process: each stripe's gathers run on its own
device, and the reference's collectives (``pmin``/``pmax`` over ``edge``)
copy the stripes' partials to the data row's first device and reduce them
there.
"""

from .closure_sharded import ShardedClosureEngine
from .serving import ShardedServingEngine
from .sharded import Mesh, ShardedCheckEngine, make_mesh, sharded_check

__all__ = [
    "Mesh",
    "ShardedCheckEngine",
    "ShardedClosureEngine",
    "ShardedServingEngine",
    "make_mesh",
    "sharded_check",
]
