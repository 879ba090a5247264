from gem_tpu_torch.render.products import (  # noqa: F401
    FREE_SPACE,
    INSCRIBED_INFLATED,
    LETHAL_OBSTACLE,
    NO_INFORMATION,
    costmap_from_points,
    costmap_from_traversability,
    distance_to_lethal,
    elevation_heatmap,
    grid_point_cloud,
    inflate_costmap,
    orthomosaic,
)
