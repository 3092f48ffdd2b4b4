"""The plain reference: the models the port serves and trains, written in
plain PyTorch in float32 (TF32 off), with no kernel, cache or batching of
the port.  Nothing here imports `repro_torch`, `repro` or `jax`."""
