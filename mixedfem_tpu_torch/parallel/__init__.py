"""Several ranks, one shard each, over torch.distributed (port of
mixedfem_tpu/parallel/)."""
