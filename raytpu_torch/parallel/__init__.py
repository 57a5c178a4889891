"""The pixel mesh and its collectives on torch.distributed."""

from raytpu_torch.parallel.mesh import (PIXEL_AXIS, Mesh, all_gather_rows,
                                        all_reduce_sum, describe_devices,
                                        gather_image, initialize_distributed,
                                        local_device, make_mesh, pixel_set)

__all__ = ["PIXEL_AXIS", "Mesh", "all_gather_rows", "all_reduce_sum",
           "describe_devices", "gather_image", "initialize_distributed",
           "local_device", "make_mesh", "pixel_set"]
