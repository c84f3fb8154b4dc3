from .generator import SubTerrain, Terrain
from .heightfield import (TerrainData, flat_terrain, from_numpy, sample_ceiling, sample_height,
                          sample_height_and_normal, sample_normal)
