"""Data parallelism over a ``torch.distributed`` process group (counterpart
of ``spatial_clip_tpu.parallel``): one process per device, the global batch
sharded over the ranks."""
