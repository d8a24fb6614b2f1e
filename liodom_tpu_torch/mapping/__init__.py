"""The mapping slice of the port: hash-grid global map, local-map extraction
and the fused odometry + mapping step."""

from liodom_tpu_torch.mapping.grid import (MapState, cell_keys, count_cells,
                                           get_local_map, get_map, init_map,
                                           local_map_offsets, map_entropy,
                                           update_map, update_map_full)
from liodom_tpu_torch.mapping.service import (MappingService,
                                              chained_combined_image_step,
                                              combined_image_step,
                                              init_combined)

__all__ = ["MapState", "init_map", "update_map", "update_map_full",
           "get_map", "get_local_map", "local_map_offsets", "map_entropy",
           "cell_keys", "count_cells", "MappingService", "init_combined",
           "combined_image_step", "chained_combined_image_step"]
