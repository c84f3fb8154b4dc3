from .heightfield import TerrainData, flat_terrain, sample_height
