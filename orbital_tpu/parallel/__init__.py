"""Multi-device and ensemble parallelism: device meshes, shard_map ring
forces, and vmapped Monte-Carlo ensembles."""
