"""Multi-device serving and training: sequence parallelism
(:mod:`.sequence`), tensor and data parallelism (:mod:`.sharding`,
:mod:`.inference`) and the sharded train step (:mod:`.train`)."""
