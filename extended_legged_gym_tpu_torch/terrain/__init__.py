from .generator import SubTerrain, Terrain
from .heightfield import (TerrainData, flat_terrain, from_numpy, sample_ceiling, sample_height,
                          sample_height_and_normal, sample_normal)
from .dynamic_obstacles import (DynamicObstacleConfig, StoneState, generate_stones,
                                reset_stones, step_stones, stone_robot_forces)
