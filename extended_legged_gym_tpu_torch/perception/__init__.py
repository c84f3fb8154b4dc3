from .patterns import make_pattern, cone_pattern, spherical_pattern, spherical2_pattern, grid_pattern
from .raycast import RayCaster, raycast, RaycastResult
from .sdf import MeshSDF, query_sdf, SDFResult
from .depth_camera import DepthCameraRaycast, DepthCameraFake, make_depth_camera, pinhole_ray_grid
