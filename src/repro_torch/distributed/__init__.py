"""Distribution on torch.distributed: the mesh context, the sharding rules and the compressed cross-pod reduction."""
