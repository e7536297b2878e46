"""Multi-GPU serving: tensor, sequence and data parallelism over
torch.distributed (sharding, collectives, ring, multihost)."""
