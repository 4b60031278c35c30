"""keto_tpu_torch: the Check, Expand and list paths of keto_tpu in PyTorch
and CUDA.

A second package beside ``keto_tpu``. It answers Zanzibar-style Check
requests two ways. The default closure engine snapshots the tuple store
into a node vocabulary and COO edge arrays, splits off the small interior
subgraph, builds a bounded all-pairs distance matrix ``D`` over that
interior once per snapshot on the GPU (the masked-SpMV kernel in
``csrc/masked_spmv.cu``), and answers every check batch by gathers into
``D``. The frontier engine (``DeviceCheckEngine``) runs a batched BFS over
the whole graph instead; its packed mode, for graphs whose interior is too
large for ``D``, propagates bitpacked frontiers with the kernel in
``csrc/packed_propagate.cu``. Writes reach the closure through a write
overlay (``engine/overlay.py``) instead of a rebuild. Expand trees come
from the snapshot's forward CSR (``engine/device.py``), and list queries
from the transposed closure ``D^T`` beside ``D`` on the card
(``engine/listing.py``). ``driver/`` with ``api/`` and ``cli/`` serve
Check, Expand, the list queries and tuple writes over REST
(``python -m keto_tpu_torch.cli serve -c config.json``). ``parallel/``
spreads the check over a grid of devices, and ``engine/autotune.py`` tunes
the serving knobs from the wall-clock ledger.

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``keto_tpu``: each module it needs is its own trimmed copy, and its
docstring names the ``keto_tpu`` counterpart. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

# the keto_tpu release whose behaviour this package ports (GET /version)
__version__ = "0.3.0"
