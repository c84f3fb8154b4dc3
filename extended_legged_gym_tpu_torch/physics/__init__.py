from .contact import ContactParams, default_contact_params, sphere_terrain_contact
from .engine import (EnvPhysParams, PhysState, SimParams, StepReport, default_env_params,
                     default_sim_params, initial_state, physics_step)
from .model import RobotModel, geom_indices_matching
from .serialize import load_model
