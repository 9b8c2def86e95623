from repro_torch.data.pipeline import (SyntheticLMData, host_shard,
                                       make_global_batch)

__all__ = ["SyntheticLMData", "host_shard", "make_global_batch"]
