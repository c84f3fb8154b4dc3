"""The port covers the JAX package's public surface.

* Names: every public top-level definition of each JAX module outside
  ``scripts/`` (functions, classes, module-level assignments, and in an
  ``__init__.py`` the names it imports from the package), and every public
  method of its classes, exists in the port module of the same path, or
  stands in ``RENAMED`` (the port's name for it) or in ``DELIBERATE`` (why
  the port has no counterpart).  The JAX side is read from the source, the
  port side from the imported module.
* Parameters: every public function and method the two packages share
  takes the JAX parameters by name, or its entry in ``PARAM_RENAMED`` (the
  port's name) or ``PARAMS`` (why the port has no such parameter) says
  otherwise.  JAX's PRNG ``key`` is excused everywhere (``KEY``), and JAX's
  ``*args`` / ``**kw`` are not compared.
* Files: every JAX ``scripts/*.py`` has a port script of the same name.
* Config fields: every config class of ``envs/legged_robot_config.py`` has
  the JAX class's fields, with its defaults, and no others.  Each robot's
  published default pose equals the JAX constant, and the joints where it
  differs from the model JSON's ``default_dof_pos`` (which the env stands
  in, as the JAX env does) are listed.
"""
import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest

from extended_legged_gym_tpu.envs import legged_robot_config as jcfg_mod
from extended_legged_gym_tpu.utils.config import class_to_dict as jclass_to_dict
from extended_legged_gym_tpu_torch.envs import legged_robot_config as cfg_mod
from extended_legged_gym_tpu_torch.utils.config import class_to_dict

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "extended_legged_gym_tpu"
PORT_ROOT = REPO / "extended_legged_gym_tpu_torch"

# JAX name (module path::name or ::Class.method) -> the port's (module
# path::name)
RENAMED = {
    "physics/model.py::rpy_to_matrix": "physics/urdf.py::rpy_to_matrix",
    "physics/model.py::RobotModel.body_indices_matching":
        "physics/model.py::body_indices_matching",
    "physics/urdf.py::geom_indices_matching": "physics/model.py::geom_indices_matching",
}

_FLAX_SETUP = "flax submodule set-up; nn.Module.__init__ does it"

# names (module path::name or ::Class.method, or a whole module path) ->
# why the port has no counterpart
DELIBERATE = {
    "ops/tile_math.py": "Pallas tuple arithmetic; the port's counterparts are the device "
                        "functions of csrc/physics_step.cu",
    "ops/physics_kernel.py::build_physics_kernel": "Pallas builder; the CUDA entries of "
                                                   "csrc/physics_step.cu take its place",
    "ops/physics_kernel.py::build_flat_physics_kernel": "Pallas builder; DecimatedEnvStep / "
                                                        "EnvStep launch the CUDA kernel",
    "ops/physics_kernel.py::pack_state": "Pallas lane packing; DecimatedEnvStep.pack packs "
                                         "the kernel's SoA rows",
    "ops/physics_kernel.py::unpack_state": "Pallas lane packing; DecimatedEnvStep.unpack",
    "ops/physics_kernel.py::pack_rows": "Pallas lane packing; DecimatedEnvStep.pack",
    "ops/physics_kernel.py::LANE": "TPU vreg lane width; the CUDA kernel runs a warp per env",
    "ops/physics_kernel.py::SUB": "TPU vreg sublane count; no counterpart on the card",
    "ops/physics_kernel.py::TILE": "TPU tile of envs; the CUDA kernel blocks 4 envs",
    "utils/export.py::export_policy_stablehlo": "StableHLO export; the port exports "
                                                "policy.pt2 with torch.export",
    "utils/export.py::load_stablehlo_policy": "StableHLO import; torch.export.load reads "
                                              "policy.pt2",
    "rl/ppo.py::PPOState": "flax/optax train state; the port's PPO holds nn.Module "
                           "parameters and its optimizer state",
    "rl/ppo.py::make_optimizer": "optax chain; rl/ppo.py's flat-vector clip + Adam",
    "rl/runner.py::TrainState": "flax train state; the runner keeps the modules",
    "rl/distillation.py::DistillationState": "flax/optax state; Distillation keeps its "
                                             "module and optimizer",
    "models/rnd.py::RNDState": "flax state; RandomNetworkDistillation is an nn.Module",
    "rl/torch_compat.py::torch_actor_critic_to_flax": "its counterpart is "
                                                      "rsl_rl_state_dict (a torch state dict "
                                                      "the port's ActorCritic loads)",
    "models/networks.py::ActorCritic.setup": _FLAX_SETUP,
    "models/networks.py::ActorCriticRecurrent.setup": _FLAX_SETUP,
    "models/student_teacher.py::StudentTeacher.setup": _FLAX_SETUP,
    "models/student_teacher.py::StudentTeacherRecurrent.setup": _FLAX_SETUP,
    "models/rnd.py::RandomNetworkDistillation.init": "flax parameter and optimizer "
                                                     "initialisation; the module initialises "
                                                     "in __init__",
    "rl/distillation.py::Distillation.init": "flax parameter and optimizer initialisation; "
                                             "Distillation.__init__ builds them",
}


KEY = "JAX's PRNG key: the port draws from a torch.Generator (or a seed) and takes injected draws"
_FUNCTIONAL = ("JAX's functional state, passed in and returned; the port's module and "
               "optimizer hold it")
_INTERPRET = "Pallas's interpreter; the port runs the kernel's plain version on a CPU tensor"
_ILQR = "passed on as **kw to ilqr_solve_batched, whose parameter it is"
_EXPORT = "the port takes the module, which carries its parameters and shapes"

# JAX function (module path::name or ::Class.method) -> {JAX parameter: the
# port's name for it}
PARAM_RENAMED = {
    "rl/ppo.py::ppo_update": {"axis_name": "mesh"},
    "rl/ppo.py::ppo_update_recurrent": {"axis_name": "mesh"},
}

# JAX function -> {JAX parameter: why the port's function has none}
PARAMS = {
    "rl/ppo.py::ppo_update": {"network": _FUNCTIONAL, "ppo_state": _FUNCTIONAL},
    "rl/ppo.py::ppo_update_recurrent": {"network": _FUNCTIONAL, "ppo_state": _FUNCTIONAL},
    "models/rnd.py::RandomNetworkDistillation.intrinsic_reward": {"state": _FUNCTIONAL},
    "models/rnd.py::RandomNetworkDistillation.predictor_loss": {
        "state": _FUNCTIONAL, "predictor_params": _FUNCTIONAL},
    "rl/distillation.py::Distillation.act": {"state": _FUNCTIONAL},
    "rl/distillation.py::Distillation.update": {"state": _FUNCTIONAL},
    "rl/distillation.py::Distillation.update_on_actions": {"state": _FUNCTIONAL},
    "models/student_teacher.py::load_teacher_from_actor_critic": {
        "st_params": "the port copies into the student-teacher module, which holds them"},
    "rl/torch_compat.py::permute_params_to_our_dof_order": {
        "params": "the port permutes a torch state dict, its `state`"},
    "utils/export.py::export_policy_as_jit": {"params": _EXPORT},
    "utils/export.py::export_recurrent_policy_as_jit": {
        "params": _EXPORT, "num_obs": _EXPORT, "rnn_type": _EXPORT, "rnn_hidden_size": _EXPORT},
    "ops/physics_kernel.py::make_env_step": {"interpret": _INTERPRET},
    "ops/physics_kernel.py::make_env_step_rough": {"interpret": _INTERPRET},
    "ops/physics_kernel.py::make_decimated_env_step": {
        "interpret": _INTERPRET,
        "torque_limits": "the port reads model.torque_limits, what the JAX env passes "
                         "(envs/legged_robot.py:326)"},
    "rl/ppo.py::compute_gae": {"timeouts": "the JAX body never reads it; the caller folds the "
                                           "timeout bootstrap into the rewards"},
    "terrain/confined.py::tunnel_terrain": {
        "wall_thickness": "JAX deletes it unread (terrain/confined.py:60)"},
    "terrain/confined.py::confined_gap_terrain": {
        "platform_size": "JAX deletes it unread (terrain/confined.py:152)"},
    "terrain/heightfield.py::flat_terrain": {"size": "a plane either way",
                                             "hscale": "a plane either way"},
    "trajopt/riccati.py::ilqr_solve": {k: _ILQR for k in (
        "n_iters", "reg_init", "alphas", "reg_min", "reg_max", "u_clip", "hessian", "prox_x",
        "prox_u")},
    "parallel/mesh.py::shard_batch": {
        "axis_name": "the port's mesh has one axis; its `axis` is the tensor dimension"},
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py")
                  if p.relative_to(JAX_ROOT).parts[0] != "scripts")


def _public(name: str) -> bool:
    return not name.startswith("_")


def jax_surface(rel: str):
    """(top-level names, {class: methods}) of the JAX module at ``rel``."""
    tree = ast.parse((JAX_ROOT / rel).read_text())
    names, methods = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            methods[node.name] = {b.name for b in node.body
                                  if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                                  and _public(b.name)}
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif (rel.endswith("__init__.py") and isinstance(node, ast.ImportFrom)
              and node.level > 0):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if _public(n)}, methods


def _port_module(rel: str):
    return importlib.import_module("extended_legged_gym_tpu_torch."
                                   + rel[:-3].replace("/", ".").replace(".__init__", "")
                                   if rel != "__init__.py" else "extended_legged_gym_tpu_torch")


def _excused(rel: str, name: str) -> bool:
    return rel in DELIBERATE or f"{rel}::{name}" in DELIBERATE


def _port_has(key: str) -> bool:
    """The port defines ``key`` (module path::name or ::Class.attr)."""
    rel, _, qual = key.partition("::")
    obj = _port_module(rel)
    for part in qual.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("rel", _jax_modules())
def test_public_names_have_a_port_counterpart(rel):
    names, methods = jax_surface(rel)
    if rel in DELIBERATE:
        assert not (PORT_ROOT / rel).exists(), f"{rel} is ported: take it out of DELIBERATE"
        return
    mod = _port_module(rel)
    missing = []
    for name in sorted(names):
        if _excused(rel, name):
            assert not hasattr(mod, name), f"{rel}::{name} exists: take it out of DELIBERATE"
            continue
        key = f"{rel}::{name}"
        if key in RENAMED:
            assert _port_has(RENAMED[key]), (key, RENAMED[key])
            continue
        if not hasattr(mod, name):
            missing.append(name)
            continue
        for meth in sorted(methods.get(name, ())):
            qual = f"{name}.{meth}"
            if _excused(rel, qual):
                assert not hasattr(getattr(mod, name), meth), \
                    f"{rel}::{qual} exists: take it out of DELIBERATE"
                continue
            if f"{rel}::{qual}" in RENAMED:
                assert _port_has(RENAMED[f"{rel}::{qual}"]), (qual, RENAMED[f"{rel}::{qual}"])
            elif not hasattr(getattr(mod, name), meth):
                missing.append(qual)
    assert not missing, f"{rel}: no port counterpart for {missing}"


def _jax_functions(rel: str):
    """{qualified name: AST node} of the public functions and methods of the
    JAX module at ``rel`` (properties excluded)."""
    out = {}
    for node in ast.parse((JAX_ROOT / rel).read_text()).body:
        if isinstance(node, ast.FunctionDef) and _public(node.name):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            for b in node.body:
                if (isinstance(b, ast.FunctionDef) and _public(b.name) and not any(
                        isinstance(d, ast.Name) and d.id == "property"
                        for d in b.decorator_list)):
                    out[f"{node.name}.{b.name}"] = b
    return out


def _jax_params(fn: ast.FunctionDef):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _port_params(key: str):
    """The parameter names of the port's counterpart of ``key`` (``None``
    where the port has none to compare)."""
    rel, _, qual = RENAMED.get(key, key).partition("::")
    obj = _port_module(rel)
    for part in qual.split("."):
        obj = getattr(obj, part, None)
    if obj is None or not callable(obj):
        return None
    return [p for p in inspect.signature(obj).parameters if p not in ("self", "cls")]


@pytest.mark.parametrize("rel", _jax_modules())
def test_public_parameters_have_a_port_counterpart(rel):
    missing = []
    for qual, fn in sorted(_jax_functions(rel).items()):
        if rel in DELIBERATE or _excused(rel, qual) or _excused(rel, qual.split(".")[0]):
            continue
        key = f"{rel}::{qual}"
        port = _port_params(key)
        if port is None:
            continue
        for p in _jax_params(fn):
            if p == "key" or p in port or p in PARAMS.get(key, ()):
                continue
            if PARAM_RENAMED.get(key, {}).get(p) not in port:
                missing.append(f"{qual}({p})")
    assert not missing, f"{rel}: the port lacks the parameters {missing}"


def test_parameter_tables_name_real_differences():
    """Every PARAMS and PARAM_RENAMED entry names a parameter of the JAX
    function that the port's lacks, and a rename names one it has."""
    for table in (PARAMS, PARAM_RENAMED):
        for key, params in table.items():
            rel, _, qual = key.partition("::")
            jax_params = _jax_params(_jax_functions(rel)[qual])
            port = _port_params(key)
            for p in params:
                assert p in jax_params and p not in port, (key, p)
    for key, names in PARAM_RENAMED.items():
        assert set(names.values()) <= set(_port_params(key)), key


def test_exception_tables_name_real_jax_definitions():
    """Every RENAMED and DELIBERATE entry names something the JAX package
    defines, so neither table outlives what it excuses."""
    for key in list(RENAMED) + list(DELIBERATE):
        rel, _, name = key.partition("::")
        assert (JAX_ROOT / rel).exists(), key
        if name:
            names, methods = jax_surface(rel)
            cls, _, meth = name.partition(".")
            assert cls in names and (not meth or meth in methods[cls]), key


@pytest.mark.parametrize("script", sorted(p.name for p in (JAX_ROOT / "scripts").glob("*.py")))
def test_every_jax_script_has_a_port_script(script):
    assert (PORT_ROOT / "scripts" / script).is_file(), script


def _config_classes():
    return sorted(n for n, v in vars(jcfg_mod).items()
                  if isinstance(v, type) and dataclasses.is_dataclass(v)
                  and v.__module__ == jcfg_mod.__name__)


@pytest.mark.parametrize("name", _config_classes())
def test_config_class_fields_and_defaults_equal_jax(name):
    jcls, cls = getattr(jcfg_mod, name), getattr(cfg_mod, name)
    assert [f.name for f in dataclasses.fields(cls)] == \
        [f.name for f in dataclasses.fields(jcls)], name
    got, want = class_to_dict(cls()), jclass_to_dict(jcls())
    for field in want:
        assert got[field] == want[field], (name, field, got[field], want[field])


# each robot's published default pose against its model JSON's
# default_dof_pos: the joints where they differ (the env reads the JSON, as
# the JAX env does)
DEFAULT_POSES = {
    ("anymal_c", "ANYMAL_C_DEFAULT_ANGLES", "anymal_c"): (),
    ("anymal_b", "ANYMAL_C_DEFAULT_ANGLES", "anymal_b"): (),
    ("a1", "A1_DEFAULT_ANGLES", "a1"): (),
    ("go2", "GO2_DEFAULT_ANGLES", "go2"): (),
    ("elspider_air", "ELSPIDER_DEFAULT_ANGLES", "elspider_air"): (),
    ("cyberdog2", "CYBERDOG2_DEFAULT_ANGLES", "cyberdog2"): (),
    ("franka", "FRANKA_DEFAULT_ANGLES", "franka"): ("panda_joint2", "panda_joint4",
                                                     "panda_joint6", "panda_joint7"),
}


@pytest.mark.parametrize("module,const,model", sorted(DEFAULT_POSES))
def test_default_pose_constants_against_the_model_json(module, const, model):
    from extended_legged_gym_tpu_torch.physics import load_model

    angles = getattr(importlib.import_module(f"extended_legged_gym_tpu_torch.robots.{module}"),
                     const)
    jangles = getattr(importlib.import_module(f"extended_legged_gym_tpu.robots.{module}"), const)
    assert angles == jangles
    m = load_model(str(JAX_ROOT / "robots" / "data" / f"{model}.json"))
    assert sorted(angles) == sorted(m.joint_names)
    differ = tuple(n for n, v in zip(m.joint_names, m.default_dof_pos)
                   if not np.isclose(angles[n], v, atol=1e-6))
    assert differ == DEFAULT_POSES[(module, const, model)]


def test_env_stands_in_the_model_json_pose():
    """Where the published pose and the JSON differ (Franka), the env's
    default joint positions are the JSON's."""
    from extended_legged_gym_tpu_torch.robots.franka import FRANKA_DEFAULT_ANGLES, Franka, franka_cfg

    cfg = franka_cfg()
    cfg.env.num_envs = 2
    env = Franka(cfg, device="cpu")
    np.testing.assert_array_equal(env.default_dof_pos.numpy(), env.model.default_dof_pos)
    assert cfg.init_state.default_joint_angles == FRANKA_DEFAULT_ANGLES
    assert env.default_dof_pos[1].item() != FRANKA_DEFAULT_ANGLES["panda_joint2"]
