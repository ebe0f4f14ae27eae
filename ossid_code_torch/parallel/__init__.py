from ossid_code_torch.parallel.mesh import make_mesh, replicate, shard_batch
