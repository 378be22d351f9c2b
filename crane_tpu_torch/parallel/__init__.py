"""Multi-device serving: sequence parallelism (:mod:`.sequence`). Tensor
parallelism and the sharded train step are not ported yet."""
