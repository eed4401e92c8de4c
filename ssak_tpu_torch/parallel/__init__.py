from ssak_tpu_torch.parallel.mesh import init_distributed, make_mesh, replicate, shard_params
from ssak_tpu_torch.parallel.sharding import WAV2VEC2_RULES, WHISPER_RULES, partition_spec_for

__all__ = ["init_distributed", "make_mesh", "shard_params", "replicate", "partition_spec_for", "WHISPER_RULES",
           "WAV2VEC2_RULES"]
