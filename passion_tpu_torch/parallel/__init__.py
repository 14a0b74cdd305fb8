"""Data parallelism over `torch.distributed` (the counterpart of
`passion_tpu/parallel/`): one process per card (`world`)."""
