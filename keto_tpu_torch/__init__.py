"""keto_tpu_torch: the closure Check path of keto_tpu in PyTorch and CUDA.

A second package beside ``keto_tpu``. It answers Zanzibar-style Check
requests with the default closure engine: the tuple store is snapshotted
into a node vocabulary and COO edge arrays, split into the small interior
subgraph, a bounded all-pairs distance matrix ``D`` over that interior is
built once per snapshot on the GPU (the masked-SpMV kernel in
``csrc/masked_spmv.cu``), and every check batch is answered by gathers into
``D``.

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``keto_tpu``: each module it needs is its own trimmed copy, and its
docstring names the ``keto_tpu`` counterpart. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
