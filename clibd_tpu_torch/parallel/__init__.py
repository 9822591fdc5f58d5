"""Process groups, device lists and the collectives between ranks (the port
of `clibd_tpu/parallel/`)."""

from .mesh import (DATA_AXIS, Mesh, all_gather_tensor, all_gather_with_grad, all_hosts_agree,
                   all_reduce_grads, all_reduce_mean, backend_for, broadcast_from_main,
                   create_mesh, free_port, host_id, is_main_process, local_mesh, local_shard,
                   maybe_initialize_distributed, mesh_is_multiprocess, num_hosts,
                   pad_to_multiple)

__all__ = ["DATA_AXIS", "Mesh", "all_gather_tensor", "all_gather_with_grad", "all_hosts_agree",
           "all_reduce_grads", "all_reduce_mean", "backend_for", "broadcast_from_main",
           "create_mesh", "free_port", "host_id", "is_main_process", "local_mesh", "local_shard",
           "maybe_initialize_distributed", "mesh_is_multiprocess", "num_hosts",
           "pad_to_multiple"]
