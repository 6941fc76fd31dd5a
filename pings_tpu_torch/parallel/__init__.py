"""Multi-process sharding on ``torch.distributed`` (counterpart of
``pings_tpu/parallel``): ``distributed`` (runtime and collectives) and
``mesh`` (sharded rendering and training)."""
