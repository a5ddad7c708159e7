"""Several devices: data-parallel serving (ShardedDefenseGAN), the
data-parallel train step and process-group bootstrap, and the
tensor-parallel channel split (port of the JAX package's parallel/).

The JAX package's sharding objects (batch_sharding, replicated_sharding,
global_batch_sharding) have no counterpart: a mesh here is a tuple of
torch devices and placement is explicit (shard_batch, .to(device)).
"""

from defensegan_torch.parallel.mesh import (DATA_AXIS, make_mesh,
                                            shard_batch,
                                            validate_batch_for_mesh,
                                            validate_projection_sharding)
from defensegan_torch.parallel.distributed import (initialize_distributed,
                                                   make_dp_train_step,
                                                   spawn_group)
from defensegan_torch.parallel.serving import ShardedDefenseGAN
from defensegan_torch.parallel.tp import (MODEL_AXIS, make_mesh_2d,
                                          shard_params_tp, tp_generator_forward,
                                          tp_spec)

__all__ = ["DATA_AXIS", "make_mesh", "shard_batch", "validate_batch_for_mesh",
           "validate_projection_sharding", "initialize_distributed",
           "make_dp_train_step", "spawn_group", "ShardedDefenseGAN",
           "MODEL_AXIS", "make_mesh_2d", "shard_params_tp",
           "tp_generator_forward", "tp_spec"]
