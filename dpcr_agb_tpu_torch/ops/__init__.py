"""Tensor ops of the serving path: masked reductions, the dense-grid convs,
and the two ops backed by hand-written kernels (the sparse-site stem conv
and the masked k3/s2 max pool)."""
